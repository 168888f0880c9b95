"""Dependency-free JPEG decoder (counterpart of ``imageio.v2.imread`` for
JPEG files in sailor_tpu/assets: imageio reads them through Pillow, which
decodes with libjpeg-turbo at its defaults).

``decode_jpeg`` returns what imageio returns for the same file, bit for
bit: (H, W, 3) uint8 for a colour file, (H, W) uint8 for a greyscale one.
It reads

- baseline and extended sequential Huffman files (SOF0, SOF1) and
  progressive ones (SOF2: spectral selection, successive approximation of
  DC and AC, first and refinement scans, end-of-band runs);
- restart intervals (DRI, RSTn), byte stuffing and fill bytes, any
  Huffman tables, any size and any integral sampling factors;
- colour as libjpeg reads it: YCbCr unless an Adobe APP14 marker says
  transform 0 (or, with neither a JFIF nor an Adobe marker, the components
  are named R, G, B), then RGB with no conversion. The EXIF orientation is
  not applied (imageio.v2 leaves it).

The pixels follow libjpeg-turbo's defaults exactly: the ISLOW integer IDCT
(``jidctint.c``), *fancy* upsampling (``jdsample.c``: h2v1, h2v2 and h1v2
triangle filters with their biases and edge columns, box replication for
other factors and for planes at most 2 samples wide) and the ``jdcolor.c``
YCbCr tables.

Refused, each with an error that names the case (ROADMAP A 10 says what
imageio does with them): arithmetic coding (SOF9-11), lossless (SOF3),
hierarchical (SOF5-7, SOF13-15) and 12-bit files, 4-component CMYK/YCCK
files, and progressive files whose scans leave a low coefficient
incomplete (libjpeg then smooths the blocks).

The entropy decoding is serial; it runs in C++ (``csrc/image_decode.cpp``,
the ``"image"`` host library), as do the IDCT, the upsampling and the
colour conversion. ``decode_jpeg(data, plain=True)`` runs the plain
version, a Python entropy decoder and numpy for the rest; the tests hold
the two equal.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

# zigzag index -> natural (row-major) index of the 8x8 block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
SOF_NAMES = {
    0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
SIGNATURE = b"\xff\xd8\xff"
# libjpeg's progressive block smoothing looks at the first 10 coefficients
_SMOOTHED_COEFS = 10


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "bw_alloc", "bh_alloc", "offset",
                 "dw", "dh", "quant", "coef_bits")


class _Frame:
    def __init__(self, marker, data):
        if marker in SOF_NAMES:
            raise NotImplementedError(f"{SOF_NAMES[marker]} JPEG files are not supported")
        self.progressive = marker == 0xC2
        precision, self.height, self.width, n = struct.unpack(">BHHB", data[:6])
        if precision != 8:
            raise NotImplementedError(f"{precision}-bit JPEG samples are not supported "
                                      "(only 8-bit)")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG with an empty frame (or a DNL height)")
        self.comps = []
        for i in range(n):
            c = _Component()
            c.cid, hv, c.tq = data[6 + 3 * i], data[7 + 3 * i], data[8 + 3 * i]
            c.h, c.v = hv >> 4, hv & 15
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                raise ValueError(f"invalid JPEG sampling factors {c.h}x{c.v}")
            c.quant, c.coef_bits = None, [-1] * 64
            self.comps.append(c)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        total = 0
        for c in self.comps:
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
            if n > 1:
                c.bw_alloc, c.bh_alloc = self.mcux * c.h, self.mcuy * c.v
            else:
                c.bw_alloc, c.bh_alloc = c.bw, c.bh
            c.offset = total
            total += c.bw_alloc * c.bh_alloc
        self.coefs = np.zeros((total, 64), np.int16)  # zigzag order


class _Huffman:
    """A canonical Huffman table (the JPEG standard's BITS and HUFFVAL)."""

    def __init__(self, counts, values):
        self.counts, self.values = list(counts), bytes(values)
        self.maxcode, self.valptr, self.mincode = [-1] * 18, [0] * 17, [0] * 17
        self.overfull = False
        code = k = 0
        for length in range(1, 17):
            n = self.counts[length - 1]
            if n:
                self.valptr[length], self.mincode[length] = k, code
                code += n
                k += n
                self.maxcode[length] = code - 1
            self.overfull = self.overfull or code >= 1 << length  # a code of all ones or more
            code <<= 1

    def check(self, dc: bool) -> None:
        """Raise for a table libjpeg refuses when a scan reads it (jdhuff.c,
        JERR_BAD_HUFF_TABLE): counts that overfill the code space, or a DC
        symbol above 15."""
        if self.overfull or (dc and any(v > 15 for v in self.values)):
            raise ValueError("malformed JPEG Huffman table")


class _Bits:
    """The entropy-coded bit stream from ``pos``: stuffed 0xFF 00 pairs read
    as 0xFF, fill bytes skipped; at a marker it gives zero bits, as libjpeg
    does."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.acc, self.n, self.marker = data, pos, 0, 0, -1

    def _byte(self) -> int:
        data, pos = self.data, self.pos
        if self.marker >= 0 or pos >= len(data):
            return 0
        b = data[pos]
        if b != 0xFF:
            self.pos = pos + 1
            return b
        q = pos + 1
        while q < len(data) and data[q] == 0xFF:
            q += 1
        if q < len(data) and data[q] == 0:
            self.pos = q + 1
            return 0xFF
        self.marker = pos
        return 0

    def bit(self) -> int:
        if self.n == 0:
            self.acc, self.n = self._byte(), 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def receive_extend(self, s: int) -> int:
        if s == 0:
            return 0
        v = self.bits(s)
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    def huff(self, t: _Huffman) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if code <= t.maxcode[length]:
                return t.values[t.valptr[length] + code - t.mincode[length]]
        return 0  # a bad code: libjpeg warns and decodes 0

    def restart(self) -> None:
        """Drop the bits left, then read the next marker if it is an RSTn."""
        self.acc = self.n = 0
        pos = self.marker if self.marker >= 0 else _next_marker(self.data, self.pos)
        if pos + 1 < len(self.data) and 0xD0 <= self.data[pos + 1] <= 0xD7:
            self.pos, self.marker = pos + 2, -1
        else:
            self.pos, self.marker = pos, pos

    def end(self) -> int:
        return self.marker if self.marker >= 0 else _next_marker(self.data, self.pos)


def _next_marker(data: bytes, pos: int) -> int:
    """Index of the next 0xFF of a marker (0xFF then a byte other than 0x00
    and 0xFF) at or after ``pos``; len(data) if there is none."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            return n
        q = pos + 1
        while q < n and data[q] == 0xFF:
            q += 1
        if q < n and data[q] != 0:
            return q - 1
        pos = q


def _scan_blocks(frame: _Frame, scomps):
    """(component index in the scan, block index) of each block of each MCU,
    as a list of MCUs: interleaved scans walk the MCU grid, a one-component
    scan walks that component's own blocks."""
    if len(scomps) == 1:
        c = frame.comps[scomps[0][0]]
        return [[(0, c.offset + y * c.bw_alloc + x)] for y in range(c.bh) for x in range(c.bw)]
    mcus = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            mcu = []
            for si, (ci, _, _) in enumerate(scomps):
                c = frame.comps[ci]
                for by in range(c.v):
                    for bx in range(c.h):
                        mcu.append((si, c.offset + (my * c.v + by) * c.bw_alloc
                                    + mx * c.h + bx))
            mcus.append(mcu)
    return mcus


def _scan_plain(data, pos, frame, scomps, tables, ss, se, ah, al, restart) -> int:
    """Entropy-decode one scan into ``frame.coefs`` (the plain version of
    ``sailor_torch_jpeg_scan``); returns the index of the marker after it."""
    bits = _Bits(data, pos)
    coefs = frame.coefs
    pred = [0] * len(scomps)
    eobrun = 0
    dc_tabs = [tables[0].get(d) for _, d, _ in scomps]
    ac_tabs = [tables[1].get(a) for _, _, a in scomps]
    for m, mcu in enumerate(_scan_blocks(frame, scomps)):
        if restart and m and m % restart == 0:
            bits.restart()
            pred = [0] * len(scomps)
            eobrun = 0
        for si, b in mcu:
            blk = coefs[b]
            if not frame.progressive:
                s = bits.huff(dc_tabs[si])
                pred[si] += bits.receive_extend(s)
                blk[0] = pred[si]
                k = 1
                while k < 64:
                    rs = bits.huff(ac_tabs[si])
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = bits.receive_extend(s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0 and ah == 0:
                s = bits.huff(dc_tabs[si])
                pred[si] += bits.receive_extend(s)
                blk[0] = np.int16(pred[si] << al)
            elif ss == 0:
                if bits.bit():
                    blk[0] |= np.int16(1 << al)
            elif ah == 0:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = bits.huff(ac_tabs[si])
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = bits.receive_extend(s) * (1 << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.bits(r) if r else 0) - 1
                        break
                    k += 1
            else:
                eobrun = _refine_ac(bits, blk, ac_tabs[si], ss, se, al, eobrun)
    return bits.end()


def _refine_ac(bits, blk, tab, ss, se, al, eobrun) -> int:
    """One block of an AC refinement scan (``decode_mcu_AC_refine``)."""
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.huff(tab)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.bit() else m1
            elif r != 15:
                eobrun = (1 << r) + (bits.bits(r) if r else 0)
                break
            while k <= se:
                c = int(blk[k])
                if c:
                    if bits.bit() and not c & p1:
                        blk[k] = c + (p1 if c >= 0 else m1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[min(k, 63)] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            c = int(blk[k])
            if c and bits.bit() and not c & p1:
                blk[k] = c + (p1 if c >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun


def _scan_native(data, pos, frame, scomps, tables, ss, se, ah, al, restart) -> int:
    """``_scan_plain`` in C++ (``sailor_torch_jpeg_scan``)."""
    from sailor_tpu_torch.kernels import host_lib

    lib = host_lib.load("image")
    tab = np.zeros((2, 4, 272), np.int32)
    for cls in range(2):
        for i, t in tables[cls].items():
            tab[cls, i, :16] = t.counts
            tab[cls, i, 16:16 + len(t.values)] = np.frombuffer(t.values, np.uint8)
    params = [ss, se, ah, al, restart, int(frame.progressive), frame.mcux, frame.mcuy,
              len(scomps), frame.coefs.shape[0]]
    for ci, d, a in scomps:
        c = frame.comps[ci]
        params += [c.h, c.v, c.bw, c.bh, c.bw_alloc, c.offset, d, a]
    p = np.asarray(params, np.int32)
    end = lib.sailor_torch_jpeg_scan(
        data, len(data), pos, p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frame.coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if end < 0:
        raise ValueError("malformed JPEG scan")
    return end


# ---------------------------------------------------------------- pixels

_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
        "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
        "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995,
        "3_072711026": 25172}


def _idct_1d(x, shift):
    """One pass of jidctint.c's ISLOW IDCT over the 8 inputs ``x`` (int64
    arrays), descaled by ``shift`` bits."""
    f = _FIX
    z1 = (x[2] + x[6]) * f["0_541196100"]
    tmp2 = z1 + x[6] * -f["1_847759065"]
    tmp3 = z1 + x[2] * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                          tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_plane(coefs: np.ndarray, quant: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh * bw, 64) zigzag coefficients and a natural-order quantisation
    table -> the (bh * 8, bw * 8) uint8 sample plane (ISLOW, the range
    limit clamping around +128)."""
    blk = np.zeros((coefs.shape[0], 64), np.int64)
    blk[:, NATURAL_ORDER] = coefs
    blk = (blk * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d([blk[:, k, :] for k in range(8)], 11)  # columns: ws[row] (N, 8 cols)
    ws = np.stack(ws, 1)
    out = _idct_1d([ws[:, :, k] for k in range(8)], 18)  # rows: out[col] (N, 8 rows)
    out = np.clip(np.stack(out, 2) + 128, 0, 255).astype(np.uint8)
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def upsample(plane: np.ndarray, dw: int, dh: int, rh: int, rv: int, width: int,
             height: int) -> np.ndarray:
    """A component's decoded plane (its real samples are [:dh, :dw]) ->
    (height, width) uint8, as jdsample.c upsamples by (rh, rv): fancy h2v1,
    h1v2 and h2v2 triangle filters, else box replication."""
    p = plane[:dh, :dw].astype(np.int32)
    if rh == 1 and rv == 1:
        out = p
    elif rv == 1 and rh == 2 and dw > 2:
        left = np.concatenate([p[:, :1], p[:, :-1]], 1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
        out = np.stack([(3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2], 2).reshape(dh, -1)
    elif rh == 1 and rv == 2:
        up = np.concatenate([p[:1], p[:-1]], 0)
        down = np.concatenate([p[1:], p[-1:]], 0)
        out = np.stack([(3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2], 1).reshape(-1, dw)
    elif rh == 2 and rv == 2 and dw > 2:
        up = np.concatenate([p[:1], p[:-1]], 0)
        down = np.concatenate([p[1:], p[-1:]], 0)
        rows = np.stack([3 * p + up, 3 * p + down], 1).reshape(-1, dw)
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4],
                       2).reshape(2 * dh, -1)
    else:
        out = np.repeat(np.repeat(p, rv, 0), rh, 1)
    return out[:height, :width].astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _pixels_plain(frame: _Frame, rgb: bool) -> np.ndarray:
    planes = []
    for c in frame.comps:
        raw = frame.coefs[c.offset:c.offset + c.bw_alloc * c.bh_alloc]
        plane = idct_plane(raw, c.quant, c.bh_alloc, c.bw_alloc)
        planes.append(upsample(plane, c.dw, c.dh, frame.hmax // c.h, frame.vmax // c.v,
                               frame.width, frame.height))
    if len(planes) == 1:
        return planes[0]
    if rgb:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def _pixels_native(frame: _Frame, rgb: bool) -> np.ndarray:
    from sailor_tpu_torch.kernels import host_lib

    lib = host_lib.load("image")
    n = len(frame.comps)
    out = np.empty((frame.height, frame.width, n) if n > 1 else (frame.height, frame.width),
                   np.uint8)
    params = [frame.width, frame.height, n, int(rgb)]
    for c in frame.comps:
        params += [c.bw_alloc, c.bh_alloc, c.offset, c.dw, c.dh, frame.hmax // c.h,
                   frame.vmax // c.v]
    p = np.asarray(params, np.int32)
    quant = np.stack([c.quant for c in frame.comps]).astype(np.int32)
    rc = lib.sailor_torch_jpeg_pixels(
        frame.coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError("JPEG pixel pass failed")
    return out


# ---------------------------------------------------------------- markers

def decode_jpeg(data: bytes, *, plain: bool = False) -> np.ndarray:
    """JPEG bytes -> the array ``imageio.v2.imread`` gives (module
    docstring). ``plain`` runs the Python entropy decoder and the numpy
    pixel pass in place of the C++ library. A malformed file raises
    ValueError("JPEG: ..."), a refused one NotImplementedError."""
    try:
        return _decode(bytes(data), plain)
    except (ValueError, IndexError, struct.error) as e:  # truncated fields too
        raise ValueError(f"JPEG: {e or 'truncated file'}") from e


def _decode(data: bytes, plain: bool) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    scan = _scan_plain if plain else _scan_native
    quant: dict[int, np.ndarray] = {}
    tables: tuple[dict, dict] = ({}, {})
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    pos = 2
    n = len(data)
    while True:
        pos = _next_marker(data, pos)
        if pos + 1 >= n:
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            _read_dqt(seg, quant)
        elif marker == 0xC4:
            _read_dht(seg, tables)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif marker == 0xCC:
            raise NotImplementedError("arithmetic-coded JPEG files (DAC) are not supported")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame = _Frame(marker, seg)
            if len(frame.comps) == 4:
                raise NotImplementedError("4-component JPEG files (CMYK/YCCK) are not supported")
            if len(frame.comps) != 3 and len(frame.comps) != 1:
                raise NotImplementedError(
                    f"{len(frame.comps)}-component JPEG files are not supported")
        elif marker == 0xDC:
            raise NotImplementedError("JPEG files with a DNL marker are not supported")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame")
            ns = seg[0]
            if not 1 <= ns <= 4:
                raise ValueError(f"JPEG scan of {ns} components")
            scomps = []
            for i in range(ns):
                cid, td = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next((j for j, c in enumerate(frame.comps) if c.cid == cid), None)
                if ci is None:
                    raise ValueError(f"JPEG scan names an unknown component {cid}")
                if any(ci == s[0] for s in scomps):
                    raise ValueError(f"JPEG scan names component {cid} twice")
                c = frame.comps[ci]
                if c.quant is None:  # libjpeg latches the table at the first scan
                    if c.tq not in quant:
                        raise ValueError(f"JPEG quantisation table {c.tq} is not defined")
                    c.quant = quant[c.tq]
                scomps.append((ci, td >> 4, td & 15))
            if ns > 1 and sum(frame.comps[ci].h * frame.comps[ci].v for ci, _, _ in scomps) > 10:
                raise ValueError("JPEG MCU of more than 10 blocks")  # jdinput.c's limit
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if not frame.progressive:
                ss, se, ah, al = 0, 63, 0, 0
            elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss and ns != 1) or al > 13:
                raise ValueError(f"invalid progressive JPEG scan Ss={ss} Se={se} Al={al}")
            for ci, d, a in scomps:
                used = [(0, d)] if ss == 0 and ah == 0 else []  # the tables libjpeg checks
                if ss or not frame.progressive:
                    used.append((1, a))
                for cls, slot in used:
                    if slot not in tables[cls]:
                        raise ValueError("JPEG scan uses an undefined Huffman table")
                    tables[cls][slot].check(dc=cls == 0)
                bits = frame.comps[ci].coef_bits
                for k in range(ss, se + 1):
                    bits[k] = al
            pos = scan(data, pos, frame, scomps, tables, ss, se, ah, al, restart)
    if frame is None:
        raise ValueError("JPEG without a frame")
    for c in frame.comps:
        if c.quant is None:
            raise ValueError(f"JPEG component {c.cid} appears in no scan")
    if frame.progressive and _smoothed(frame):
        raise NotImplementedError(
            "progressive JPEG whose scans leave low AC coefficients incomplete "
            "(libjpeg's block smoothing) is not supported")
    for c in frame.comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise NotImplementedError(
                f"fractional JPEG sampling {c.h}x{c.v} of {frame.hmax}x{frame.vmax}")
    # jdapimin.c default_decompress_parms: JFIF, then Adobe, then the ids
    ids = [c.cid for c in frame.comps]
    rgb = len(ids) == 3 and not jfif and (
        adobe_transform == 0 if adobe else ids == [82, 71, 66])
    return (_pixels_plain if plain else _pixels_native)(frame, rgb)


def _smoothed(frame: _Frame) -> bool:
    """Whether libjpeg-turbo would smooth the blocks (jdcoefct.c
    smoothing_ok): every component's DC is known, its quantisers of the
    first coefficients are nonzero, and some coefficient among them is
    still incomplete after the last scan."""
    useful = False
    for c in frame.comps:
        if c.coef_bits[0] < 0 or not c.quant[NATURAL_ORDER[:_SMOOTHED_COEFS]].all():
            return False
        useful = useful or any(b != 0 for b in c.coef_bits[1:_SMOOTHED_COEFS])
    return useful


def _read_dqt(seg: bytes, quant: dict) -> None:
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        size = 128 if pq else 64
        raw = seg[pos + 1:pos + 1 + size]
        vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int32)
        if vals.size != 64 or tq > 3:
            raise ValueError("malformed JPEG DQT segment")
        table = np.zeros(64, np.int32)
        table[NATURAL_ORDER] = vals
        quant[tq] = table
        pos += 1 + size


def _read_dht(seg: bytes, tables) -> None:
    pos = 0
    while pos < len(seg):
        tc, th = seg[pos] >> 4, seg[pos] & 15
        counts = list(seg[pos + 1:pos + 17])
        total = sum(counts)
        if tc > 1 or th > 3 or total > 256 or len(counts) != 16:
            raise ValueError("malformed JPEG DHT segment")
        tables[tc][th] = _Huffman(counts, seg[pos + 17:pos + 17 + total])
        pos += 17 + total
