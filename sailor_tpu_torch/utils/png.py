"""Dependency-free PNG codec (counterpart of sailor_tpu/utils/png.py, and of
``imageio.v2.imread`` for PNG files in sailor_tpu/assets): the CLI's
``--out`` and the frame capture write with ``encode_png``; the texture,
glTF, OBJ and FBX importers read with ``decode_png``, so the port needs no
image library.

``decode_png`` reads every PNG: chunked IDAT, the five row filters, plain
and Adam7-interlaced scanlines (each of the seven passes filtered on its
own row width, the empty passes of small images skipped), colour types 0
(grey), 2 (RGB), 3 (palette, with PLTE and tRNS), 4 (grey + alpha) and 6
(RGBA), bit depths 1, 2, 4, 8 and 16 where the format allows them. It
returns what ``imageio.v2.imread`` returns for the same file (imageio
reads PNG through Pillow):

- grey: (H, W); 1 bit as bool, 2 and 4 bits scaled to uint8 (x85, x17),
  8 bits uint8, 16 bits uint16;
- RGB, grey + alpha and RGBA: (H, W, 3 | 2 | 4) uint8; 16-bit samples
  keep their high byte, and 16-bit grey + alpha comes out as RGBA (the
  grey repeated);
- palette: (H, W, 3) uint8 RGB;
- a tRNS chunk is ignored, a palette's too (Pillow keeps it aside as
  ``info["transparency"]`` and imageio converts to the palette's RGB).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def encode_png(img_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    h, w = img_u8.shape[:2]
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def srgb_to_u8(final_srgb) -> np.ndarray:
    """An sRGB image in [0, 1] (a tensor on any device, or an array) ->
    uint8 on the host: clip(x * 255 + 0.5) truncated, the reference's
    conversion. A tensor is converted where it lies and read back once,
    as uint8."""
    if not torch.is_tensor(final_srgb):
        final_srgb = torch.from_numpy(np.asarray(final_srgb))
    return torch.clamp(final_srgb * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


def _chunks(data: bytes):
    """(IHDR fields, IDAT bytes, PLTE bytes or None)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    return hdr, b"".join(idat), plte


def _paeth_row(cur: bytearray, prior, bpp: int) -> None:
    """Undo the Paeth filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior, bpp: int) -> None:
    """Undo the Average filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) uint8. None, Sub and
    Up run as numpy row operations; Average and Paeth walk their row."""
    if raw.size != h * (1 + stride):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + stride)}")
    rows = raw.reshape(h, 1 + stride)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    out = rows[:, 1:].copy()
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f = ftype[y]
        cur = out[y]
        if f == 1:  # Sub: a running sum in each of the bpp byte lanes
            lanes = -(-stride // bpp) * bpp
            pad = np.zeros(lanes, np.uint8)
            pad[:stride] = cur
            cur[:] = np.cumsum(pad.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)[:stride]
        elif f == 2:  # Up
            cur += prior
        elif f in (3, 4):
            row = bytearray(cur.tobytes())
            (_average_row if f == 3 else _paeth_row)(row, prior.tobytes(), bpp)
            cur[:] = np.frombuffer(bytes(row), np.uint8)
        prior = cur
    return out


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, stride) packed samples of 1, 2 or 4 bits, most significant
    first -> (h, w) uint8 sample values."""
    bits = np.unpackbits(rows, axis=1)
    h = rows.shape[0]
    bits = bits[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)


# Adam7: (x0, y0, dx, dy) of each of the seven passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _samples(raw: np.ndarray, w: int, h: int, nch: int, depth: int) -> np.ndarray:
    """(h * (1 + stride)) filtered bytes of one w x h image -> (h, w, nch)
    samples: uint8 for depths up to 8 (unpacked below 8), uint16 for 16."""
    bits_px = nch * depth
    stride = -(-w * bits_px // 8)
    rows = _unfilter(raw, h, stride, max(1, bits_px // 8))
    if depth < 8:
        return _unpack_bits(rows, w, depth)[..., None]
    if depth == 8:
        return rows.reshape(h, w, nch)
    be = rows.reshape(h, w, nch, 2).astype(np.uint16)
    return (be[..., 0] << 8) | be[..., 1]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the array ``imageio.v2.imread`` gives (module docstring);
    raises ValueError on a malformed file."""
    (w, h, depth, ctype, comp, filt, interlace), idat, plte = _chunks(data)
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"invalid PNG colour type {ctype} with bit depth {depth}")
    if comp != 0 or filt != 0:
        raise ValueError(f"unknown PNG compression {comp} or filter method {filt}")
    if interlace not in (0, 1):
        raise ValueError(f"unknown PNG interlace method {interlace}")
    nch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if interlace == 0:
        samples = _samples(raw, w, h, nch, depth)
    else:  # Adam7: each non-empty pass is filtered on its own row width
        samples = np.zeros((h, w, nch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            n = ph * (1 + -(-pw * nch * depth // 8))
            samples[y0::dy, x0::dx] = _samples(raw[pos:pos + n], pw, ph, nch, depth)
            pos += n
        if pos != raw.size:
            raise ValueError(f"PNG data holds {raw.size} bytes, expected {pos}")
    if depth == 16:
        if ctype == 0:
            return samples[..., 0]
        samples = (samples >> 8).astype(np.uint8)  # the high byte, as Pillow reads 16-bit colour
        if ctype == 4:
            samples = samples[..., [0, 0, 0, 1]]
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal
        return full[samples[..., 0]]
    if ctype == 0:
        g = samples[..., 0]
        if depth == 1:
            return g.astype(bool)
        return g * np.uint8(255 // ((1 << depth) - 1))
    return np.ascontiguousarray(samples)
