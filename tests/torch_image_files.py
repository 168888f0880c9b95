"""Writers of BMP, TGA, Radiance HDR, GIF, OpenEXR and arithmetic-coded and
lossless JPEG files for the decoder tests (numpy and the port's own JPEG
tables only, so that chip_smoke.py can import it on the card's machine,
which has no image library; the tests also write files with Pillow)."""

import struct

import numpy as np

from sailor_tpu_torch.utils.jpeg import ARITH_STATES


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


# ---------------------------------------------------------------- JPEG
#
# Writers of the JPEG codings Pillow cannot write: arithmetic-coded
# (T.81 Annex D's QM coder as libjpeg's jcarith.c drives it, sequential
# SOF9 and progressive SOF10) and lossless (SOF3). Each file is held to
# imageio in the tests, so a writer at fault shows there.

class QMEncoder:
    """jcarith.c's arith_encode and finish_pass: binary decisions in, the
    entropy-coded bytes (0xFF stuffed) out. A statistics bin is one byte
    of a bytearray: bit 7 the MPS, the rest the state index."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        # by state (T.81 Table D.2, as the port's decoder holds it; imageio
        # checks every file this coder writes, the table with it): Qe, the
        # next state after an LPS with the MPS switch in bit 7, the next
        # state after an MPS
        self.tab = [(q, s << 7 | lps, m) for q, lps, m, s in ARITH_STATES]

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _stacked(self):
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm = self.tab[sv & 0x7F]
        a = self.a - qe
        if val != sv >> 7:  # the LPS
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:  # renormalise, a byte out every 8 shifts
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self._byte_out(c >> 19)
                c &= 0x7FFFF
                ct = 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def _byte_out(self, temp):
        if temp > 0xFF:  # a carry into the stacked bytes
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            self._stacked()
            self.buffer = temp & 0xFF

    def finish(self) -> bytes:
        """Flush (T.81 D.1.8 as finish_pass does it) and return the bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            self._stacked()
        if self.c & 0x7FFF800:  # the last bytes, unless they are zeros
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _qm_value(enc, st, fixed, p, v, k, kx):
    """A nonzero value ``v`` (T.81 Figures F.6-F.9): its sign, magnitude
    category and bits. ``p`` is the sign's bin for a DC value (k = 0; the
    fixed bin for AC) plus, for AC, the first category bin."""
    if k:
        enc.encode(fixed, 0, int(v < 0))
        p += 1
    else:
        enc.encode(st, p, int(v < 0))
        p += 1 + (v < 0)
    v = abs(v) - 1
    m = 0
    if v:
        enc.encode(st, p, 1)
        m, v2 = 1, v >> 1
        if k:
            if v2:
                enc.encode(st, p, 1)
                m = 2
                p = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    enc.encode(st, p, 1)
                    m <<= 1
                    p += 1
                    v2 >>= 1
        else:
            p = 20
            while v2:
                enc.encode(st, p, 1)
                m <<= 1
                p += 1
                v2 >>= 1
    enc.encode(st, p, 0)
    p += 14
    cat = m
    m >>= 1
    while m:
        enc.encode(st, p, int(bool(m & v)))
        m >>= 1
    return cat


def _ac_shift(c, al):
    """A coefficient after the point transform: |c| >> al, sign kept."""
    return -((-c) >> al) if c < 0 else c >> al


def _qm_ac_first(enc, st, fixed, blk, ss, se, al, kx):
    ke = se
    while ke > 0 and _ac_shift(blk[ke], al) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        enc.encode(st, p, 0)
        while True:
            v = _ac_shift(blk[k], al)
            if v:
                enc.encode(st, p + 1, 1)
                break
            enc.encode(st, p + 1, 0)
            p += 3
            k += 1
        _qm_value(enc, st, fixed, p + 1, v, k, kx)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _qm_ac_refine(enc, st, fixed, blk, ss, se, ah, al):
    ke = se
    while ke > 0 and _ac_shift(blk[ke], al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and _ac_shift(blk[kex], ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        if k > kex:
            enc.encode(st, p, 0)
        while True:
            v = abs(_ac_shift(blk[k], al))
            if v:
                if v >> 1:
                    enc.encode(st, p + 2, v & 1)
                else:
                    enc.encode(st, p + 1, 1)
                    enc.encode(fixed, 0, int(blk[k] < 0))
                break
            enc.encode(st, p + 1, 0)
            p += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _jpeg_geometry(width, height, comps, unit=8):
    """Each component's real blocks (bw, bh) and the MCU grid."""
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    real = [(-(-(-(-width * c["h"] // hmax)) // unit), -(-(-(-height * c["v"] // vmax)) // unit))
            for c in comps]
    return real, -(-width // (unit * hmax)), -(-height // (unit * vmax))


def _scan_mcus(width, height, comps, scan_comps, unit=8):
    """The (component, block row, block column) of each block of each MCU of
    a scan, as libjpeg walks them."""
    real, mcux, mcuy = _jpeg_geometry(width, height, comps, unit)
    if len(scan_comps) == 1:
        ci = scan_comps[0]
        bw, bh = real[ci]
        return [[(ci, y, x)] for y in range(bh) for x in range(bw)]
    return [[(ci, my * comps[ci]["v"] + by, mx * comps[ci]["h"] + bx)
             for ci in scan_comps for by in range(comps[ci]["v"]) for bx in range(comps[ci]["h"])]
            for my in range(mcuy) for mx in range(mcux)]


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _jpeg_head(width, height, comps, sof, quant, jfif, adobe, precision=8):
    head = b"\xff\xd8"
    if jfif:
        head += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    for tq, table in sorted(quant.items()):
        head += _segment(0xDB, bytes([tq]) + bytes(int(v) for v in table))
    head += _segment(sof, struct.pack(">BHHB", precision, height, width, len(comps)) + b"".join(
        bytes([c["id"], c["h"] << 4 | c["v"], c.get("tq", 0)]) for c in comps))
    return head


def arith_jpeg(width, height, comps, quant, *, script=None, restart=0, dac=(), jfif=True,
               adobe=None) -> bytes:
    """An arithmetic-coded JPEG. ``comps``: dicts with ``id``, ``h``,
    ``v``, ``tq``, the conditioning tables ``dc`` and ``ac`` and ``coefs``,
    the (block rows, block columns, 64) zigzag coefficients of the
    component's MCU-padded grid. ``quant``: {slot: 64 values in zigzag
    order}. Without ``script`` a sequential SOF9 file of one interleaved
    scan; with it a progressive SOF10 file of its scans, each (component
    indices, Ss, Se, Ah, Al). ``restart``: MCUs per restart interval.
    ``dac``: (class, table, value) conditioning entries."""
    out = _jpeg_head(width, height, comps, 0xCA if script else 0xC9, quant, jfif, adobe)
    if dac:
        out += _segment(0xCC, b"".join(bytes([tc << 4 | tb, v]) for tc, tb, v in dac))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    bounds = {tb: (v & 15, v >> 4) for tc, tb, v in dac if tc == 0}
    kxs = {tb: v for tc, tb, v in dac if tc == 1}
    for scan in script or [(tuple(range(len(comps))), 0, 63, 0, 0)]:
        sc, ss, se, ah, al = scan
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(
            bytes([comps[ci]["id"], comps[ci]["dc"] << 4 | comps[ci]["ac"]]) for ci in sc)
            + bytes([ss, se, ah << 4 | al]))
        out += _arith_scan(width, height, comps, sc, ss, se, ah, al, bool(script), restart,
                           bounds, kxs)
    return out + b"\xff\xd9"


def _arith_scan(width, height, comps, sc, ss, se, ah, al, prog, restart, bounds, kxs):
    uses_dc = not prog or (ss == 0 and ah == 0)
    data = bytearray()
    mcus = _scan_mcus(width, height, comps, sc)
    blocks = {ci: np.asarray(comps[ci]["coefs"]).tolist() for ci in sc}  # Python ints: faster
    for start in range(0, len(mcus), restart or len(mcus)):
        if start:
            data += bytes([0xFF, 0xD0 + (start // restart - 1) % 8])
        enc = QMEncoder()
        dc_stats = {comps[ci]["dc"]: bytearray(64) for ci in sc}
        ac_stats = {comps[ci]["ac"]: bytearray(256) for ci in sc}
        fixed = bytearray([113])
        last = {ci: 0 for ci in sc}
        ctx = {ci: 0 for ci in sc}
        for mcu in mcus[start:start + (restart or len(mcus))]:
            for ci, y, x in mcu:
                blk = blocks[ci][y][x]
                d, a = comps[ci]["dc"], comps[ci]["ac"]
                if uses_dc:
                    st = dc_stats[d]
                    m = blk[0] >> al
                    diff = m - last[ci]
                    if diff == 0:
                        enc.encode(st, ctx[ci], 0)
                        ctx[ci] = 0
                    else:
                        last[ci] = m
                        enc.encode(st, ctx[ci], 1)
                        cat = _qm_value(enc, st, fixed, ctx[ci] + 1, diff, 0, 0)
                        lo, hi = bounds.get(d, (0, 1))
                        if cat < (1 << lo) >> 1:
                            ctx[ci] = 0
                        elif cat > (1 << hi) >> 1:
                            ctx[ci] = 12 + 4 * (diff < 0)
                        else:
                            ctx[ci] = 4 + 4 * (diff < 0)
                    if not prog:
                        _qm_ac_first(enc, ac_stats[a], fixed, blk, 1, 63, 0, kxs.get(a, 5))
                elif ss == 0:
                    enc.encode(fixed, 0, (blk[0] >> al) & 1)
                elif ah == 0:
                    _qm_ac_first(enc, ac_stats[a], fixed, blk, ss, se, al, kxs.get(a, 5))
                else:
                    _qm_ac_refine(enc, ac_stats[a], fixed, blk, ss, se, ah, al)
        data += enc.finish()
    return bytes(data)


def simple_progression(ncomps: int):
    """libjpeg's jpeg_simple_progression script (jcparam.c) for a YCbCr or
    a greyscale file: (component indices, Ss, Se, Ah, Al) per scan."""
    if ncomps == 1:
        return [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
            ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
            ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
            ((0,), 1, 63, 1, 0)]


# Annex K's DC luminance table (BITS, HUFFVAL): the lossless writer's
# table for every component
K3_DC_COUNTS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
K3_DC_SYMBOLS = tuple(range(12))


def lossless_jpeg(planes, predictor: int, *, al: int = 0, restart_rows: int = 0,
                  ids=None, sampling=None, interleave: bool = True, jfif: bool = False,
                  adobe=None) -> bytes:
    """A lossless SOF3 JPEG of uint8 ``planes``, one per component at its
    own size (ceil(W h / hmax) x ceil(H v / vmax) for the ``sampling``
    factors (h, v), all 1 by default): predictor 1-7, point transform
    ``al``, a restart interval of ``restart_rows`` MCU rows, Annex K's DC
    luminance Huffman table for every difference. One interleaved scan, or
    one scan per component."""
    planes = [np.asarray(p, np.int64) >> al for p in planes]
    sampling = sampling or [(1, 1)] * len(planes)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    width, height = planes[0].shape[1] * hmax // sampling[0][0], \
        planes[0].shape[0] * vmax // sampling[0][1]
    ids = ids or list(range(1, len(planes) + 1))
    comps = [{"id": i, "h": h, "v": v, "tq": 0} for i, (h, v) in zip(ids, sampling)]
    out = _jpeg_head(width, height, comps, 0xC3, {}, jfif, adobe)
    out += _segment(0xC4, bytes([0x00, *K3_DC_COUNTS, *K3_DC_SYMBOLS]))
    codes, code, k = {}, 0, 0
    for length, n in enumerate(K3_DC_COUNTS, 1):
        for _ in range(n):
            codes[K3_DC_SYMBOLS[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    scans = [tuple(range(len(planes)))] if interleave else [(i,) for i in range(len(planes))]
    for sc in scans:
        one = len(sc) == 1
        mcus = _scan_mcus(width, height, comps, sc, unit=1)
        per_row = planes[sc[0]].shape[1] if one else -(-width // hmax)
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        diffs = {}
        for ci in sc:
            p = planes[ci]
            v = 1 if one else sampling[ci][1]
            d = np.zeros_like(p)
            for y in range(p.shape[0]):
                first = y == 0 or (restart_rows and y % (restart_rows * v) == 0)
                ra = np.concatenate([[0], p[y, :-1]])
                if first:
                    pred = ra.copy()
                    pred[0] = 1 << (7 - al)
                else:
                    rb, rc = p[y - 1], np.concatenate([[0], p[y - 1, :-1]])
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
                    pred[0] = p[y - 1, 0]
                d[y] = ((p[y] - pred + 32768) & 0xFFFF) - 32768
            diffs[ci] = d
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ids[i], 0]) for i in sc)
                        + bytes([predictor, 0, al]))
        bits = []
        for m, mcu in enumerate(mcus):
            if restart_rows and m and m % (restart_rows * per_row) == 0:
                bits.append(None)  # a restart marker
            for ci, y, x in mcu:
                d = diffs[ci]
                v = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0  # dummy: 0
                s = 16 if v == -32768 else abs(v).bit_length()
                bits.append(codes[s])
                if s and s < 16:
                    bits.append((v if v > 0 else v + (1 << s) - 1, s))
        out += _huffman_bytes(bits)
    return out + b"\xff\xd9"


def _huffman_bytes(codes) -> bytes:
    """(code, length) pairs to bytes, padded with 1 bits and 0xFF stuffed;
    None ends an interval with the next RSTn marker."""
    out = bytearray()
    acc = n = rst = 0

    def flush():
        nonlocal acc, n
        if n % 8:
            pad = 8 - n % 8
            acc, n = acc << pad | (1 << pad) - 1, n + pad
        while n:
            n -= 8
            b = (acc >> n) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
        acc = 0

    for c in codes:
        if c is None:
            flush()
            out.extend([0xFF, 0xD0 + rst % 8])
            rst += 1
            continue
        acc, n = acc << c[1] | c[0], n + c[1]
        while n >= 8:
            n -= 8
            b = (acc >> n) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
            acc &= (1 << n) - 1
    flush()
    return bytes(out)
