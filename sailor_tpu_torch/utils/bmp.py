"""Windows BMP decoder (the counterpart of ``imageio.v2.imread`` for ``BM``
files in sailor_tpu/assets; imageio reads them through Pillow).

``decode_bmp`` reads the BITMAPCOREHEADER (12 bytes) and the INFO headers
of 40 to 124 bytes: 1-, 4- and 8-bit palettes, 16 (5-5-5), 24 and 32 bits,
BI_RLE4 and BI_RLE8, BI_BITFIELDS (the mask layouts Pillow accepts), rows
bottom-up or top-down (a negative height). It returns what imageio returns
for the same file:

- a palette whose entries are all grey ((0, 0, 0) and (255, 255, 255) for
  two colours, (i, i, i) for entry i otherwise): (H, W) bool for two
  colours, else (H, W) uint8 of the indices;
- any other palette: (H, W, 3) uint8 RGB;
- 16 and 24 bits, and 32 bits without an alpha mask: (H, W, 3) uint8 (a
  5-bit sample c becomes c * 255 // 31, a 6-bit one c * 255 // 63; the
  fourth byte of an uncompressed 32-bit pixel is dropped, as Pillow does);
- 32 bits with an alpha mask: (H, W, 4) uint8.

RLE: encoded runs, absolute runs (word aligned), end of line, end of
bitmap and the delta escape, which moves the write position by its two
bytes as the BMP format defines it (Pillow consumes four bytes there, so
a file with deltas is the one case where the two disagree). Pixels the
runs never write stay 0. A truncated or malformed file raises ValueError
naming BMP.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"

_BITFIELDS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
_BITFIELDS16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 31, 63, 31),
                (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 31, 31, 31)}


def _fail(msg: str):
    return ValueError(f"BMP: {msg}")


def _u16(data, off):
    return struct.unpack_from("<H", data, off)[0]


def _u32(data, off):
    return struct.unpack_from("<I", data, off)[0]


def _unpack_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Indices of a BI_RLE8/BI_RLE4 stream in file row order (H, W)."""
    out = np.zeros(w * h, np.uint8)
    n = w * h
    i = x = 0
    while i < n and pos + 1 < len(data):
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # an encoded run of one byte (two alternating nibbles)
            count = min(count, max(0, w - x))
            if rle4:
                run = np.array([byte >> 4, byte & 15], np.uint8)[np.arange(count) % 2]
            else:
                run = np.full(count, byte, np.uint8)
            out[i:i + count] = run[:n - i]
            i += count
            x += count
        elif byte == 0:  # end of line
            if i % w:
                i += w - i % w
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: right, down
            if pos + 1 >= len(data):
                break
            right, down = data[pos], data[pos + 1]
            pos += 2
            i += right + down * w
            x = i % w
        else:  # an absolute run of ``byte`` pixels, padded to a word
            nbytes = (byte + 1) // 2 if rle4 else byte
            raw = np.frombuffer(data[pos:pos + nbytes], np.uint8)
            if rle4:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:byte]
            raw = raw[:n - i]
            out[i:i + len(raw)] = raw
            if len(raw) < min(byte, n - i):
                break
            i += byte
            x += byte
            pos += nbytes + (nbytes & 1)
    return out.reshape(h, w)


def _unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(H, stride) bytes -> (H, W) indices of ``bits``-bit pixels, most
    significant first."""
    if bits == 8:
        return rows[:, :w]
    per = 8 // bits
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * bits
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w].astype(np.uint8)


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP file's bytes -> the array ``imageio.v2.imread`` gives."""
    if data[:2] != SIGNATURE:
        raise _fail("not a BMP file")
    try:
        offset = _u32(data, 10)
        hsize = _u32(data, 14)
        head = data[18:14 + hsize]
        if len(head) < hsize - 4:
            raise _fail("truncated header")
        if hsize == 12:
            w, h = _u16(head, 0), _u16(head, 2)
            bits, compression, colors, pal_pad, top_down = _u16(head, 6), 0, 0, 3, False
        elif hsize in (40, 52, 56, 64, 108, 124):
            top_down = head[7] == 0xFF
            w = struct.unpack_from("<i", head, 0)[0]
            h = _u32(head, 4)
            h = 2 ** 32 - h if top_down else h
            bits, compression = _u16(head, 10), _u32(head, 12)
            colors, pal_pad = _u32(head, 28), 4
        else:
            raise _fail(f"unsupported header size {hsize}")
    except struct.error:
        raise _fail("truncated header") from None
    if w <= 0 or h <= 0:
        raise _fail(f"bad size {w}x{h}")
    colors = colors or (1 << bits if bits <= 8 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    layout = None
    if compression == 3:  # BI_BITFIELDS
        if hsize >= 52:
            masks = tuple(_u32(head, 36 + 4 * k) for k in range(4 if hsize >= 56 else 3))
            if len(masks) == 3:
                masks += (0,)
        else:
            if len(data) < 14 + hsize + 12:
                raise _fail("truncated bit masks")
            masks = tuple(_u32(data, 14 + hsize + 4 * k) for k in range(3)) + (0,)
        if bits == 32 and masks in _BITFIELDS32:
            layout = _BITFIELDS32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            layout = "BGR"
        elif bits == 16 and masks[:3] in _BITFIELDS16:
            layout = masks[:3]
        else:
            raise _fail(f"unsupported bit-field layout {bits} bits {masks}")
    elif compression in (1, 2):  # BI_RLE8, BI_RLE4
        if bits != (8 if compression == 1 else 4):
            raise _fail(f"RLE{8 if compression == 1 else 4} with {bits} bits")
    elif compression != 0:
        raise _fail(f"unsupported compression {compression}")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _fail(f"unsupported depth {bits}")

    palette = grey = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise _fail(f"bad palette size {colors}")
        raw = data[14 + hsize:14 + hsize + pal_pad * colors]
        if len(raw) < pal_pad * colors:
            raise _fail("truncated palette")
        pal = np.frombuffer(raw, np.uint8).reshape(colors, pal_pad)[:, 2::-1]  # BGR(X) -> RGB
        want = (0, 255) if colors == 2 else range(colors)
        grey = all(bytes(pal[i][::-1]) == bytes([v]) * 3 for i, v in enumerate(want))
        palette = pal

    if compression in (1, 2):
        idx = _unpack_rle(data, offset, w, h, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        raw = data[offset:offset + stride * h]
        if len(raw) < stride * h:
            raise _fail("truncated pixel data")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        if bits <= 8:
            idx = _unpack_bits(rows, w, bits)
        elif bits == 16:
            px = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16)
            px = px[..., 0] | (px[..., 1] << 8)
            r_sh, g_sh, b_sh, r_max, g_max, b_max = (_BITFIELDS16[(0x7C00, 0x3E0, 0x1F)]
                                                     if layout is None else _BITFIELDS16[layout])
            img = np.stack([((px >> r_sh) & r_max).astype(np.uint32) * 255 // r_max,
                            ((px >> g_sh) & g_max).astype(np.uint32) * 255 // g_max,
                            ((px >> b_sh) & b_max).astype(np.uint32) * 255 // b_max], -1)
            idx = img.astype(np.uint8)
        else:
            nb = bits // 8
            px = rows[:, :nb * w].reshape(h, w, nb)
            order = layout or ("BGR" if bits == 24 else "BGRX")
            chans = {c: px[..., k] for k, c in enumerate(order)}
            names = "RGBA" if "A" in order else "RGB"
            idx = np.stack([chans[c] for c in names], -1)
    if not top_down:
        idx = idx[::-1]
    idx = np.ascontiguousarray(idx)
    if palette is None:
        return idx
    if grey:
        return idx.astype(bool) if colors == 2 else idx
    full = np.zeros((max(256, colors), 3), np.uint8)  # indices past the palette are black
    full[:colors] = palette
    return full[idx]
