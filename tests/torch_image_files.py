"""Writers of BMP, TGA and Radiance HDR files for the decoder tests (numpy
only, so that chip_smoke.py can import nothing of it and still write the
same layouts; the tests also write files with Pillow)."""

import struct

import numpy as np


def bmp(pixels: bytes, w: int, h: int, bits: int, *, palette=None, compression: int = 0,
        masks=None, header: int = 40, top_down: bool = False) -> bytes:
    """A BMP around ready-made pixel bytes. ``palette``: (N, 3) RGB uint8;
    ``masks``: the BI_BITFIELDS masks (3 after a 40-byte header, in it
    from 52 bytes)."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0")
                       for r, g, b in np.asarray(palette, np.uint8))
    extra = b""
    if header == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(pixels), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if masks is not None and header == 40:
            extra = b"".join(struct.pack("<I", m) for m in masks)
        elif header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            head += b"".join(struct.pack("<I", v) for v in m[:min(4, (header - 40) // 4)])
        head += bytes(header - len(head))
    offset = 14 + len(head) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + head + extra
            + pal + pixels)


def bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """(H, W) indices or (H, W, C) bytes, top row first -> bottom-up BMP rows
    padded to 4 bytes (indices of 1, 4 or 8 bits packed high first)."""
    out = []
    for row in rows[::-1]:
        if bits in (1, 4):
            per = 8 // bits
            r = np.concatenate([row, np.zeros(-len(row) % per, row.dtype)]).reshape(-1, per)
            shifts = np.arange(per - 1, -1, -1) * bits
            b = (r.astype(np.uint32) << shifts).sum(1).astype(np.uint8).tobytes()
        else:
            b = np.ascontiguousarray(row).tobytes()
        out.append(b + bytes(-len(b) % 4))
    return b"".join(out)


def rle8(rows: np.ndarray) -> bytes:
    """BI_RLE8 of (H, W) uint8 indices: runs of equal bytes, absolute runs
    of 3+ distinct ones, end of line after each row, end of bitmap."""
    out = bytearray()
    for row in rows[::-1]:
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 2 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            n = min(255, w - x)
            k = 3
            while k < n and row[x + k] != row[x + k - 1]:
                k += 1
            out += bytes([0, k]) + bytes(row[x:x + k]) + bytes(k & 1)
            x += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(rows: np.ndarray) -> bytes:
    """BI_RLE4 of (H, W) 4-bit indices: encoded runs of alternating pairs
    and absolute runs of four pixels, end of line, end of bitmap."""
    out = bytearray()
    for row in rows[::-1]:
        x, w = 0, len(row)
        while x < w:
            if w - x >= 4 and x % 8 == 4:
                quad = row[x:x + 4]
                out += bytes([0, 4, (quad[0] << 4) | quad[1], (quad[2] << 4) | quad[3]])
                x += 4
                continue
            a = row[x]
            b = row[x + 1] if x + 1 < w else 0
            n = 2 if x + 1 < w else 1
            while x + n < w and n < 254 and row[x + n] == (a if n % 2 == 0 else b):
                n += 1
            out += bytes([n, (a << 4) | b])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def tga(pixels: bytes, w: int, h: int, depth: int, kind: int, *, cmap=None,
        cmap_depth: int = 24, cmap_start: int = 0, descriptor: int = 0,
        image_id: bytes = b"") -> bytes:
    """A TGA around ready-made pixel (or packet) bytes; ``cmap`` is the
    colour map's raw entries (bytes)."""
    n_map = 0 if cmap is None else len(cmap) // (cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), cmap is not None, kind, cmap_start,
                       n_map, cmap_depth if cmap is not None else 0, 0, 0, w, h, depth,
                       descriptor)
    return head + image_id + (cmap or b"") + pixels


def tga_rle(px: np.ndarray, width: int | None = None) -> bytes:
    """Run-length packets over (N, bpp) pixels: repeats as run packets,
    the rest as raw packets; with ``width`` no packet crosses a row."""
    if width is not None:
        return b"".join(tga_rle(px[i:i + width]) for i in range(0, len(px), width))
    out = bytearray()
    i, n = 0, len(px)
    while i < n:
        k = 1
        while i + k < n and k < 128 and np.array_equal(px[i + k], px[i]):
            k += 1
        if k > 1:
            out += bytes([0x80 | (k - 1)]) + px[i].tobytes()
            i += k
            continue
        k = 1
        while i + k < n and k < 128 and not np.array_equal(px[i + k], px[i + k - 1]):
            k += 1
        out += bytes([k - 1]) + px[i:i + k].tobytes()
        i += k
    return bytes(out)


def rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) RGBE bytes (mantissas from frexp)."""
    m = rgb.max(-1)
    mant, e = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.maximum(m, 1e-38), 0.0)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0)
    return out


def hdr(pix: np.ndarray, *, rle: bool, magic: bytes = b"#?RADIANCE") -> bytes:
    """A Radiance file of (H, W, 4) RGBE bytes, flat or new-RLE scanlines
    (runs of 3+ equal bytes as run packets)."""
    h, w = pix.shape[:2]
    out = bytearray(magic + b"\n# written by tests\nFORMAT=32-bit_rle_rgbe\n\n"
                    + f"-Y {h} +X {w}\n".encode())
    for row in pix:
        if not rle:
            out += row.tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            ch = row[:, c]
            x = 0
            while x < w:
                k = 1
                while x + k < w and k < 127 and ch[x + k] == ch[x]:
                    k += 1
                if k >= 3:
                    out += bytes([128 + k, ch[x]])
                    x += k
                    continue
                k = 1
                while x + k < w and k < 128 and not (x + k + 2 < w and ch[x + k] == ch[x + k + 1]
                                                     == ch[x + k + 2]):
                    k += 1
                out += bytes([k]) + ch[x:x + k].tobytes()
                x += k
    return bytes(out)
