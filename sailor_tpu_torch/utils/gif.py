"""Dependency-free GIF decoder (counterpart of ``imageio.v2.imread`` for GIF
files in sailor_tpu/assets: imageio reads the first image through Pillow).

``decode_gif`` returns the first image as imageio returns it:

- with a colour table (the image's local one, else the global one), an
  (H, W, 3) uint8 RGB array, the indices looked up in that table; a
  transparency index is ignored (imageio converts Pillow's "P" image to
  the palette's RGB, dropping the alpha);
- without one, or when the table is the identity grey ramp (entry i =
  (i, i, i), which Pillow drops), an (H, W) uint8 array of the indices.

The canvas is the logical screen, grown to hold the image; pixels the
image does not cover hold the transparency index when there is one, else
index 0. LZW codes grow from the minimum code size + 1 to 12 bits, with
clear and end codes and the deferred clear (a full table stays full until
a clear code); interlaced images are put back in row order. Later images
are not read.

The LZW decoding runs in C++ (``sailor_torch_gif_lzw``, the ``"image"``
host library); ``decode_gif(data, plain=True)`` runs the plain Python
version, which the tests hold equal to it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")


def lzw_plain(data: bytes, min_code: int, npix: int) -> np.ndarray:
    """The image's LZW sub-blocks joined -> up to ``npix`` indices (the
    plain version of ``sailor_torch_gif_lzw``)."""
    if not 1 <= min_code <= 11:
        raise ValueError(f"invalid GIF LZW minimum code size {min_code}")
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    width, prev = min_code + 1, None
    out = bytearray()
    acc = nacc = 0
    pos = 0
    while len(out) < npix:
        while nacc < width and pos < len(data):
            acc |= data[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < width:
            break
        code = acc & ((1 << width) - 1)
        acc >>= width
        nacc -= width
        if code == clear:
            table = table[:clear + 2]
            width, prev = min_code + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= clear:
                break
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            break
        out += entry
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
    return np.frombuffer(bytes(out[:npix]), np.uint8)


def _lzw_native(data: bytes, min_code: int, npix: int) -> np.ndarray:
    from sailor_tpu_torch.kernels import host_lib

    out = np.zeros(npix, np.uint8)
    n = host_lib.load("image").sailor_torch_gif_lzw(
        data, len(data), min_code, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), npix)
    if n < 0:
        raise ValueError(f"invalid GIF LZW minimum code size {min_code}")
    return out[:n]


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos


def _palette(raw: bytes):
    """A colour table, or None where Pillow drops it (the grey ramp)."""
    pal = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(pal))
    if (pal == ramp[:, None]).all():
        return None
    return pal


def decode_gif(data: bytes, *, plain: bool = False) -> np.ndarray:
    """GIF bytes -> the first image as ``imageio.v2.imread`` gives it
    (module docstring). A malformed file raises ValueError("GIF: ...")."""
    try:
        return _decode(bytes(data), plain)
    except (ValueError, IndexError, struct.error) as e:  # truncated fields too
        raise ValueError(f"GIF: {e or 'truncated file'}") from e


def _decode(data: bytes, plain: bool) -> np.ndarray:
    if data[:6] not in SIGNATURES:
        raise ValueError("not a GIF file")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_pal = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + size])
        pos += size
    transparency = None
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = data[pos]
            if label == 0xF9 and len(data) > pos + 1 and data[pos + 1] >= 4:
                gce = data[pos + 2:pos + 6]
                if gce[0] & 1:
                    transparency = gce[3]
            _, pos = _sub_blocks(data, pos + 1)
            continue
        if tag != 0x2C:
            raise ValueError(f"malformed GIF: block 0x{tag:02x}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        pal = global_pal
        if iflags & 0x80:
            size = 3 << ((iflags & 7) + 1)
            pal = _palette(data[pos:pos + size])
            pos += size
        min_code = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        idx = (lzw_plain if plain else _lzw_native)(lzw, min_code, w * h)
        img = np.zeros(w * h, np.uint8)
        img[:idx.size] = idx
        img = img.reshape(h, w)
        if iflags & 0x40:
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                    np.arange(2, h, 4), np.arange(1, h, 2)])
            rows = np.empty_like(img)
            rows[order] = img
            img = rows
        cw, ch = max(width, x0 + w), max(height, y0 + h)
        canvas = np.full((ch, cw), transparency or 0, np.uint8)
        canvas[y0:y0 + h, x0:x0 + w] = img
        if pal is None:
            return canvas
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal
        return full[canvas]
    raise ValueError("GIF without an image")
