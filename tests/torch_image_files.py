"""Writers of BMP, TGA, Radiance HDR, GIF and OpenEXR files for the decoder
tests (numpy only, so that chip_smoke.py can import nothing of it and
still write the same layouts; the tests also write files with Pillow)."""

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


def lzw(indices: np.ndarray, min_code: int, *, clear_when_full: bool = True,
        clear_every: int = 0) -> bytes:
    """GIF LZW codes of ``indices``, least significant bit first. A full
    table (4096 entries) is cleared when ``clear_when_full``, else kept
    (the deferred clear: 12-bit codes, no new entries); ``clear_every`` > 0
    also emits a clear code every that many codes."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    out = bytearray()
    acc = nacc = 0

    def emit(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, clear + 2, min_code + 1

    table, nxt, width = reset()
    emit(clear, width)
    w = b""
    codes = 0
    for b in indices.reshape(-1).tobytes():
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        codes += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        elif clear_when_full:
            emit(clear, width)
            table, nxt, width = reset()
        if clear_every and codes % clear_every == 0:
            emit(clear, width)
            table, nxt, width = reset()
        w = bytes([b])
    if w:
        emit(table[w], width)
    emit(eoi, width)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _table_bits(pal) -> int:
    n = len(pal)
    bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    return bits


def gif(frames, width: int, height: int, *, global_palette=None, transparency=None,
        **lzw_kw) -> bytes:
    """A GIF89a of ``frames``: each a dict with ``indices`` (h, w) uint8 and
    optional ``x``, ``y``, ``palette`` (a local table), ``interlace``,
    ``min_code``. Tables are padded to a power of two with zeros; a
    transparency index writes a graphic control extension before each
    frame."""
    out = bytearray(b"GIF89a" + struct.pack("<HH", width, height))
    if global_palette is not None:
        bits = _table_bits(global_palette)
        out += bytes([0x80 | (bits - 1), 0, 0])
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(global_palette)] = global_palette
        out += table.tobytes()
    else:
        out += bytes([0, 0, 0])
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if transparency is not None:
            out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
        flags = 0x40 if f.get("interlace") else 0
        local = b""
        if f.get("palette") is not None:
            bits = _table_bits(f["palette"])
            flags |= 0x80 | (bits - 1)
            table = np.zeros((1 << bits, 3), np.uint8)
            table[:len(f["palette"])] = f["palette"]
            local = table.tobytes()
        out += b"," + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), w, h, flags) + local
        if f.get("interlace"):
            idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        min_code = f.get("min_code", 8)
        out += bytes([min_code]) + _blocks(lzw(idx, min_code, **lzw_kw))
    return bytes(out + b";")


def exr_minimal(w: int = 2, h: int = 2) -> bytes:
    """A scanline OpenEXR file with one uncompressed HALF channel "Y"."""
    def attr(name, kind, data):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(data)) + data

    header = (attr("channels", "chlist", b"Y\0" + struct.pack("<iB3xii", 1, 0, 1, 1) + b"\0")
              + attr("compression", "compression", b"\0")
              + attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    start = 8 + len(header) + 8 * h
    rows, offsets = b"", []
    for y in range(h):
        offsets.append(start + len(rows))
        px = np.full(w, 0x3C00, "<u2").tobytes()  # 1.0 in half floats
        rows += struct.pack("<ii", y, len(px)) + px
    return (b"\x76\x2f\x31\x01" + struct.pack("<i", 2) + header
            + b"".join(struct.pack("<Q", o) for o in offsets) + rows)
