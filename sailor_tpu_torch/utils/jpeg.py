"""Dependency-free JPEG decoder (counterpart of ``imageio.v2.imread`` for
JPEG files in sailor_tpu/assets: imageio reads them through Pillow, which
decodes with libjpeg-turbo at its defaults).

``decode_jpeg`` returns what imageio returns for the same file, bit for
bit: (H, W, 3) uint8 for a colour file, (H, W) uint8 for a greyscale one
and (H, W, 4) uint8 CMYK for a 4-component one. It reads

- sequential and progressive DCT files, Huffman-coded (SOF0, SOF1, SOF2)
  or arithmetic-coded (SOF9, SOF10: T.81 Annex F.1.4.4 and G.1.3.3 as
  libjpeg-turbo's ``jdarith.c`` decodes them, with the DAC conditioning
  bounds L, U and Kx and their defaults 0, 1 and 5); progressive scans
  of every kind: spectral selection, successive approximation of DC and
  AC, first and refinement scans, end-of-band runs;
- lossless files (SOF3: Huffman-coded differences, predictors 1-7, the
  point transform Al, restart intervals of whole rows), as ``jdlossls.c``
  and ``jddiffct.c`` undo them;
- restart intervals (DRI, RSTn), byte stuffing and fill bytes, DNL
  segments after a frame whose height is given, any Huffman tables, any
  size and any integral sampling factors;
- colour as libjpeg's ``default_decompress_parms`` chooses it. Three
  components: YCbCr unless an Adobe APP14 marker says transform 0 (or,
  with neither a JFIF nor an Adobe marker, the components are named R,
  G, B, or a lossless file names them 1, 2, 3), then RGB with no
  conversion. Four components: YCCK if an Adobe marker says a transform
  other than 0, else CMYK; Pillow reads them as rawmode ``CMYK;I``, so
  the samples come back inverted. The EXIF orientation is not applied
  (imageio.v2 leaves it).

The pixels follow libjpeg-turbo's defaults exactly: the ISLOW integer IDCT
(``jidctint.c``), *fancy* upsampling (``jdsample.c``: h2v1, h2v2 and h1v2
triangle filters with their biases and edge columns, box replication for
other factors and for planes at most 2 samples wide), the ``jdcolor.c``
YCbCr and YCCK tables, and, for a progressive file whose scans leave one
of the first AC coefficients incomplete, the block smoothing of
libjpeg-turbo 3.1's ``decompress_smooth_data`` (``jdcoefct.c``: each
coefficient still zero is estimated from the DC values of the 5 x 5
neighbouring blocks, and the DC itself when no AC data came at all).

Refused, each with an error that names the case (imageio raises on each
too): arithmetic-coded lossless (SOF11) and hierarchical (SOF5-7,
SOF13-15) files, 12-bit samples, 2-component frames, fractional sampling
factors, lossless files in YCbCr or YCCK (a JFIF marker, or an Adobe
transform other than 0), and a frame of height 0 whose height would come
in a DNL segment.

The entropy decoding is serial; it runs in C++ (``csrc/image_decode.cpp``,
the ``"image"`` host library), as do the block smoothing, the IDCT, the
upsampling and the colour conversion. ``decode_jpeg(data, plain=True)``
runs the plain version, a Python entropy decoder and numpy for the rest;
the tests hold the two equal.
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
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
SIGNATURE = b"\xff\xd8\xff"
# libjpeg's progressive block smoothing looks at the first 10 coefficients
_SMOOTHED_COEFS = 10
# colour conversions of the pixel pass (the C++ takes the same numbers)
GREY_OR_RGB, YCC, CMYK, YCCK = 0, 1, 2, 3
# T.81 Table D.2, the QM coder's probability estimation: Qe, the next
# state after an LPS and after an MPS, and whether an LPS swaps the MPS
# sense. The last row is the fixed estimate of 0.5 (T.851 Table 5) that
# libjpeg codes signs and refinement bits with.
ARITH_STATES = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
FIXED_STATE = 113
# the states packed as jaricom.c packs them: Qe << 16 | next MPS << 8 |
# switch << 7 | next LPS
_ARITAB = tuple(q << 16 | m << 8 | s << 7 | lps for q, lps, m, s in ARITH_STATES)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "bw_alloc", "bh_alloc", "offset",
                 "dw", "dh", "quant", "coef_bits")


class _Frame:
    """A frame header and what its scans decode into: ``coefs``, (blocks,
    64) int16 in zigzag order, or for a lossless frame ``samples``, each
    component's (bh_alloc, bw_alloc) plane of uint8 samples."""

    def __init__(self, marker, data):
        if marker in SOF_NAMES:
            raise NotImplementedError(f"{SOF_NAMES[marker]} JPEG files are not supported")
        self.progressive = marker in (0xC2, 0xCA)
        self.arith = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        precision, self.height, self.width, n = struct.unpack(">BHHB", data[:6])
        if precision != 8:
            raise NotImplementedError(f"{precision}-bit JPEG samples are not supported "
                                      "(only 8-bit)")
        if self.height == 0 or self.width == 0:
            raise ValueError("empty JPEG frame (a height given by a DNL segment is not "
                             "supported)")
        if n not in (1, 3, 4):
            raise NotImplementedError(f"{n}-component JPEG files are not supported")
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
        unit = 1 if self.lossless else 8  # a lossless "block" is one sample
        self.mcux = -(-self.width // (unit * self.hmax))
        self.mcuy = -(-self.height // (unit * self.vmax))
        total = 0
        for c in self.comps:
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // unit), -(-c.dh // unit)
            if n > 1:
                c.bw_alloc, c.bh_alloc = self.mcux * c.h, self.mcuy * c.v
            else:  # libjpeg rounds a lone component's rows and columns up too
                c.bw_alloc, c.bh_alloc = -(-c.bw // c.h) * c.h, -(-c.bh // c.v) * c.v
            c.offset = total
            total += c.bw_alloc * c.bh_alloc
        if self.lossless:
            self.samples = np.zeros(total, np.uint8)
        else:
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

    def check(self, dc: bool, lossless: bool = False) -> None:
        """Raise for a table libjpeg refuses when a scan reads it (jdhuff.c,
        JERR_BAD_HUFF_TABLE): counts that overfill the code space, or a DC
        symbol above 15 (above 16 in a lossless file)."""
        if self.overfull or (dc and any(v > 15 + lossless for v in self.values)):
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


class _Arith:
    """The QM decoder of T.81 Annex D as ``jdarith.c``'s ``arith_decode``
    runs it, over the entropy-coded bytes from ``pos`` (stuffed 0xFF 00
    pairs read as 0xFF; at a marker it reads zero bytes, which is legal in
    arithmetic coding). ``decode(st, i)`` decodes one binary decision with
    the statistics bin ``st[i]`` and updates the bin."""

    def __init__(self, data: bytes, pos: int):
        self.bits = _Bits(data, pos)
        self.reset()

    def reset(self) -> None:
        self.c = self.a = 0
        self.ct = -16  # read two bytes before the first decision

    def decode(self, st, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self.bits._byte()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000  # two bytes in: 0x10000 after the shift
            self.a <<= 1
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:  # the MPS, exchanged
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:  # the LPS, exchanged
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _i16(v: int) -> int:
    """``v`` wrapped to int16, as a JCOEF cast wraps it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _arith_ac_value(dec, st, fixed, p, k, kx) -> int | None:
    """A nonzero AC value once its bin ``p`` (3 (k - 1) + 1) said nonzero:
    the sign, the magnitude category (T.81 Figure F.23: twice at bin p + 1,
    then from bin 189 or 217 by Kx) and the magnitude bits (Figure F.24).
    None on a magnitude overflow."""
    sign = dec.decode(fixed, 0)
    p += 1
    m = dec.decode(st, p)
    if m and dec.decode(st, p):
        m = 2
        p = 189 if k <= kx else 217
        while dec.decode(st, p):
            m <<= 1
            if m == 0x8000:
                return None
            p += 1
    v, bit = m, m >> 1
    p += 14
    while bit:
        if dec.decode(st, p):
            v |= bit
        bit >>= 1
    return -(v + 1) if sign else v + 1


def _arith_ac(dec, st, fixed, blk, ss, se, al, kx) -> bool:
    """Coefficients ``ss``..``se`` of one block, a sequential block's AC or
    a progressive first AC scan's band (``decode_mcu``/``decode_mcu_AC_first``).
    False on a spectral or magnitude overflow."""
    k = ss
    while k <= se:
        p = 3 * (k - 1)
        if dec.decode(st, p):  # end of block
            break
        while not dec.decode(st, p + 1):
            p += 3
            k += 1
            if k > se:
                return False
        v = _arith_ac_value(dec, st, fixed, p + 1, k, kx)
        if v is None:
            return False
        blk[k] = _i16(v << al)
        k += 1
    return True


def _arith_refine_ac(dec, st, fixed, blk, ss, se, al) -> bool:
    """One block of an arithmetic AC refinement scan (``decode_mcu_AC_refine``)."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not blk[kex]:
        kex -= 1
    k = ss
    while k <= se:
        p = 3 * (k - 1)
        if k > kex and dec.decode(st, p):
            break
        while True:
            c = int(blk[k])
            if c:
                if dec.decode(st, p + 2):
                    blk[k] = _i16(c + (m1 if c < 0 else p1))
                break
            if dec.decode(st, p + 1):
                blk[k] = _i16(m1 if dec.decode(fixed, 0) else p1)
                break
            p += 3
            k += 1
            if k > se:
                return False
        k += 1
    return True


def _scan_arith_plain(data, pos, frame, scomps, cond, ss, se, ah, al, restart) -> int:
    """Arithmetic-decode one scan into ``frame.coefs`` (the plain version of
    ``sailor_torch_jpeg_scan_arith``); ``cond`` holds the DAC bounds L, U
    and Kx by table. Returns the index of the marker after the scan."""
    dec = _Arith(data, pos)
    coefs, prog = frame.coefs, frame.progressive
    dc_l, dc_u, ac_k = cond
    uses_dc = not prog or (ss == 0 and ah == 0)
    uses_ac = not prog or ss > 0
    fixed = bytearray([FIXED_STATE])
    ns = len(scomps)

    def fresh():
        dc = {d: bytearray(64) for _, d, _ in scomps} if uses_dc else {}
        ac = {a: bytearray(256) for _, _, a in scomps} if uses_ac else {}
        return dc, ac, [0] * ns, [0] * ns

    dc_stats, ac_stats, last, ctx = fresh()
    broken = False
    for m, mcu in enumerate(_scan_blocks(frame, scomps)):
        if restart and m and m % restart == 0:
            dec.bits.restart()
            dec.reset()
            dc_stats, ac_stats, last, ctx = fresh()
            broken = False
        if broken:  # libjpeg decodes nothing more until the next restart
            continue
        for si, b in mcu:
            blk = coefs[b]
            _, d, a = scomps[si]
            if uses_dc:
                st = dc_stats[d]
                s0 = ctx[si]
                if dec.decode(st, s0) == 0:
                    ctx[si] = 0
                else:
                    sign = dec.decode(st, s0 + 1)
                    p = s0 + 2 + sign
                    m0 = dec.decode(st, p)
                    mag = m0
                    if m0:  # the category: how far the loop of bins 20.. runs
                        p = 20
                        while dec.decode(st, p):
                            mag <<= 1
                            if mag == 0x8000:
                                break
                            p += 1
                    if mag == 0x8000:
                        broken = True
                        break
                    if mag < (1 << dc_l[d]) >> 1:
                        ctx[si] = 0
                    elif mag > (1 << dc_u[d]) >> 1:
                        ctx[si] = 12 + 4 * sign
                    else:
                        ctx[si] = 4 + 4 * sign
                    v, bit = mag, mag >> 1
                    p += 14
                    while bit:
                        if dec.decode(st, p):
                            v |= bit
                        bit >>= 1
                    v += 1
                    last[si] = (last[si] + (-v if sign else v)) & 0xFFFF
                blk[0] = _i16(last[si] << al)
                if prog:
                    continue
                if not _arith_ac(dec, ac_stats[a], fixed, blk, 1, 63, 0, ac_k[a]):
                    broken = True
                    break
            elif ss == 0:
                if dec.decode(fixed, 0):
                    blk[0] = _i16(int(blk[0]) | 1 << al)
            elif ah == 0:
                if not _arith_ac(dec, ac_stats[a], fixed, blk, ss, se, al, ac_k[a]):
                    broken = True
            elif not _arith_refine_ac(dec, ac_stats[a], fixed, blk, ss, se, al):
                broken = True
    return dec.bits.end()


def _lossless_rows(frame, scomps, restart):
    """A lossless scan's MCU rows, MCUs a row and MCU rows an iMCU row (1
    in an interleaved scan, the component's v in a one-component scan, whose
    MCUs are single samples), each scan component's samples an MCU across
    and down, and the MCU rows between restart markers (libjpeg-turbo's
    ``jddiffct.c`` restarts only between MCU rows: the interval must be a
    whole number of them)."""
    if len(scomps) == 1:
        c = frame.comps[scomps[0][0]]
        rows, cols, group, hv = c.bh, c.bw, c.v, [(1, 1)]
    else:
        rows, cols, group = frame.mcuy, frame.mcux, 1
        hv = [(frame.comps[ci].h, frame.comps[ci].v) for ci, _, _ in scomps]
    if restart % cols:
        raise ValueError(f"JPEG lossless restart interval {restart} is not a whole number of "
                         f"{cols}-MCU rows")
    return rows, cols, group, hv, restart // cols


def _scan_lossless_plain(data, pos, frame, scomps, tables, ss, se, ah, al, restart) -> int:
    """Decode one lossless scan into ``frame.samples`` (the plain version of
    ``sailor_torch_jpeg_scan_lossless``), an iMCU row at a time as
    ``jddiffct.c`` does: each sample's Huffman-coded difference (T.81
    H.1.2.2; category 16 is 32768 with no extra bits), then each
    component's real samples undone by the scan's predictor ``ss`` (H.1.2.1)
    modulo 2^16, row by row: the first row after the start, and the first
    row of an iMCU row in which a restart marker came, predicted from the
    left (its first sample from 2^(7 - Al)), the first sample of a row
    from the one above; then shifted left by the point transform ``al``.
    Returns the index of the marker after the scan."""
    rows, cols, group, hv, rows_per_restart = _lossless_rows(frame, scomps, restart)
    bits = _Bits(data, pos)
    tabs = [tables[0].get(d) for _, d, _ in scomps]
    prev = [None] * len(scomps)
    for top in range(0, rows, group):
        diffs = [np.zeros((group * v, cols * h), np.int64) for h, v in hv]
        for my in range(top, min(top + group, rows)):
            if rows_per_restart and my and my % rows_per_restart == 0:
                bits.restart()
                prev = [None] * len(scomps)  # for this whole iMCU row
            for mx in range(cols):
                for si, (h, v) in enumerate(hv):
                    for by in range(v):
                        for bx in range(h):
                            s = bits.huff(tabs[si])
                            diffs[si][(my - top) * v + by, mx * h + bx] = (
                                32768 if s == 16 else bits.receive_extend(s))
        for si, (ci, _, _) in enumerate(scomps):
            c = frame.comps[ci]
            for r, d in enumerate(diffs[si]):
                y = top * hv[si][1] + r
                if y >= c.bh:  # the dummy rows of the last MCU row
                    break
                row = np.zeros(c.bw, np.int64)
                up = prev[si]
                for x in range(c.bw):
                    if up is None:
                        pred = (1 << (7 - al)) if x == 0 else row[x - 1]
                    elif x == 0:
                        pred = up[0]
                    else:
                        ra, rb, rc = row[x - 1], up[x], up[x - 1]
                        pred = (ra, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[ss]
                    row[x] = (d[x] + pred) & 0xFFFF
                prev[si] = row
                start = c.offset + y * c.bw_alloc
                frame.samples[start:start + c.bw] = (row << al) & 0xFF
    return bits.end()


def _scan_native(data, pos, frame, scomps, tables, ss, se, ah, al, restart) -> int:
    """``_scan_plain`` in C++ (``sailor_torch_jpeg_scan``)."""
    tab = np.zeros((2, 4, 272), np.int32)
    for cls in range(2):
        for i, t in tables[cls].items():
            tab[cls, i, :16] = t.counts
            tab[cls, i, 16:16 + len(t.values)] = np.frombuffer(t.values, np.uint8)
    end = _lib().sailor_torch_jpeg_scan(data, len(data), pos, _scan_params(
        frame, scomps, ss, se, ah, al, restart), _i32(tab), _ptr(frame.coefs, ctypes.c_int16))
    if end < 0:
        raise ValueError("malformed JPEG scan")
    return end


def _scan_arith_native(data, pos, frame, scomps, cond, ss, se, ah, al, restart) -> int:
    """``_scan_arith_plain`` in C++ (``sailor_torch_jpeg_scan_arith``)."""
    end = _lib().sailor_torch_jpeg_scan_arith(
        data, len(data), pos, _scan_params(frame, scomps, ss, se, ah, al, restart),
        _i32(np.asarray(cond, np.int32)), _ptr(frame.coefs, ctypes.c_int16))
    if end < 0:
        raise ValueError("malformed JPEG scan")
    return end


def _scan_lossless_native(data, pos, frame, scomps, tables, ss, se, ah, al, restart) -> int:
    """``_scan_lossless_plain`` in C++ (``sailor_torch_jpeg_scan_lossless``)."""
    rows, cols, group, hv, rows_per_restart = _lossless_rows(frame, scomps, restart)
    tab = np.zeros((len(scomps), 272), np.int32)
    params = [rows, cols, rows_per_restart, ss, al, len(scomps), group]
    for si, (ci, d, _) in enumerate(scomps):
        t = tables[0][d]
        tab[si, :16] = t.counts
        tab[si, 16:16 + len(t.values)] = np.frombuffer(t.values, np.uint8)
        c = frame.comps[ci]
        params += [c.offset, c.bw_alloc, *hv[si], c.bw, c.bh]
    end = _lib().sailor_torch_jpeg_scan_lossless(
        data, len(data), pos, _i32(np.asarray(params, np.int32)), _i32(tab),
        _ptr(frame.samples, ctypes.c_uint8), frame.samples.size)
    if end < 0:
        raise ValueError("malformed JPEG scan")
    return end


def _lib():
    from sailor_tpu_torch.kernels import host_lib

    return host_lib.load("image")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a: np.ndarray):
    return _ptr(a, ctypes.c_int32)


def _scan_params(frame, scomps, ss, se, ah, al, restart):
    """The scan and its components as the C++ scans take them."""
    params = [ss, se, ah, al, restart, int(frame.progressive), frame.mcux, frame.mcuy,
              len(scomps), frame.coefs.shape[0]]
    for ci, d, a in scomps:
        c = frame.comps[ci]
        params += [c.h, c.v, c.bw, c.bh, c.bw_alloc, c.offset, d, a]
    return _i32(np.asarray(params, np.int32))


# ---------------------------------------------------------------- IDCT

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
             height: int, fancy: bool = True) -> np.ndarray:
    """A component's decoded plane (its real samples are [:dh, :dw]) ->
    (height, width) uint8, as jdsample.c upsamples by (rh, rv): fancy h2v1,
    h1v2 and h2v2 triangle filters, else box replication (always box
    without ``fancy``: libjpeg upsamples a lossless file so, its DCT
    scaled size being 1)."""
    p = plane[:dh, :dw].astype(np.int32)
    if rh == 1 and rv == 1:
        out = p
    elif not fancy:
        out = np.repeat(np.repeat(p, rv, 0), rh, 1)
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


# ---------------------------------------------------------------- block smoothing

# jdcoefct.c decompress_smooth_data's kernels over the 5 x 5 DC values
# around a block (rows above to below, columns left to right), each as
# (the kernel when AC data came, the one when only DC data came; zeros
# where that case estimates nothing): zigzag 1 (u = 1, v = 0), 3 (v = 2),
# 4 (u = v = 1), 6 (u = 3), 7 (u = 2, v = 1) and the DC; the others are
# their transposes
_Z = [0] * 5
_AC01 = np.array([[_Z, _Z, [-7, 50, 0, -50, 7], _Z, _Z],
                  [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
                   [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]])
_AC20 = np.array([[[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
                   [0, 0, -1, 0, 0]],
                  [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0],
                   [0, 0, 1, 0, 0]]])
_AC11 = np.array([[[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], _Z, [1, -10, 0, 10, -1],
                   [0, 1, 0, -1, 0]],
                  [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], _Z, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]])
_AC03 = np.array([[_Z] * 5, [_Z, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], _Z]])
_AC12 = np.array([[_Z] * 5, [_Z, [0, 1, -3, 1, 0], _Z, [0, -1, 3, -1, 0], _Z]])
_DC = np.array([[_Z] * 5, [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
                           [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]])
_T = (0, 2, 1)
#: (20, 5, 5): kernel 2 (k - 1) + dc_only for zigzag k = 1..9, then the DC's
SMOOTH_KERNELS = np.concatenate([
    _AC01, _AC01.transpose(_T), _AC20, _AC11, _AC20.transpose(_T), _AC03, _AC12,
    _AC12.transpose(_T), _AC03.transpose(_T), _DC]).astype(np.int32)
del _Z, _AC01, _AC20, _AC11, _AC03, _AC12, _DC, _T


def _smooth_rows(frame, c):
    """For each of component ``c``'s block rows, the rows libjpeg takes as
    the two above and the two below: clamped to the image, but by its
    per-iMCU-row count, which lets the last full iMCU row see the padding
    rows below it and the last partial one see only itself."""
    t, v = frame.mcuy, c.v
    rows = np.zeros((c.bh, 5), np.int64)
    for y in range(c.bh):
        i, r = divmod(y, v)
        block_rows = v if i < t - 1 else (c.bh % v or v)
        ibr, ibrs = i * block_rows + r, block_rows * t
        prev = y - 1 if ibr > 0 else y
        nxt = y + 1 if ibr < ibrs - 1 else y
        rows[y] = (y - 2 if ibr > 1 else prev, prev, y, nxt, y + 2 if ibr < ibrs - 2 else nxt)
    return rows


def _smooth_plain(frame) -> np.ndarray:
    """The coefficients as libjpeg-turbo's block smoothing hands them to
    the IDCT (``decompress_smooth_data``): in every block of every
    component, each of zigzag coefficients 1-9 whose bits are not all in
    (``coef_bits`` not 0) and that is still zero becomes an estimate from
    the 5 x 5 DC neighbourhood, rounded and capped below 2^Al; when no AC
    data came at all, 1-9 and the DC are estimated from it too."""
    out = frame.coefs.copy()
    for c in frame.comps:
        n = c.bw_alloc * c.bh_alloc
        grid = frame.coefs[c.offset:c.offset + n].reshape(c.bh_alloc, c.bw_alloc, 64)
        cols = np.clip(np.arange(c.bw)[:, None] + np.arange(-2, 3), 0, c.bw - 1)
        rows = _smooth_rows(frame, c)
        dc = grid[..., 0].astype(np.int64)[rows[:, None, :, None], cols[None, :, None, :]]
        bits = c.coef_bits
        only_dc = all(b == -1 for b in bits[1:_SMOOTHED_COEFS])
        q = c.quant[NATURAL_ORDER[:_SMOOTHED_COEFS]].astype(np.int64)
        blocks = out[c.offset:c.offset + n].reshape(c.bh_alloc, c.bw_alloc, 64)[:c.bh, :c.bw]
        for k in list(range(1, _SMOOTHED_COEFS)) + [0]:
            kern = SMOOTH_KERNELS[2 * (k - 1 if k else 9) + only_dc]
            if not kern.any():
                continue
            num = q[0] * (dc * kern).sum((2, 3))
            pred = ((q[k] << 7) + np.abs(num)) // (q[k] << 8)
            if k:
                al = bits[k]
                if al == 0:
                    continue
                if al > 0:
                    pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num < 0, -pred, pred)
            cur = blocks[..., k]
            blocks[..., k] = np.where(cur == 0, pred, cur) if k else pred
    return out


def _smooth_native(frame) -> np.ndarray:
    """``_smooth_plain`` in C++ (``sailor_torch_jpeg_smooth``)."""
    out = frame.coefs.copy()
    params = [frame.mcuy, len(frame.comps)]
    for c in frame.comps:
        params += [c.bw, c.bh, c.bw_alloc, c.bh_alloc, c.offset, c.v]
        params += c.coef_bits[:_SMOOTHED_COEFS]
    quant = np.stack([c.quant for c in frame.comps]).astype(np.int32)
    rc = _lib().sailor_torch_jpeg_smooth(
        _ptr(frame.coefs, ctypes.c_int16), _i32(quant), _i32(np.asarray(params, np.int32)),
        _i32(SMOOTH_KERNELS), _ptr(out, ctypes.c_int16))
    if rc != 0:
        raise ValueError("JPEG block smoothing failed")
    return out


# ---------------------------------------------------------------- pixels

def ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - the YCbCr -> RGB
    conversion, range limited; K passes through. -> (H, W, 4) uint8."""
    rgb = ycc_to_rgb(y, cb, cr)
    return np.concatenate([255 - rgb, k[..., None]], -1)


def _planes(frame, coefs):
    """Each component's upsampled (H, W) uint8 plane."""
    planes = []
    for c in frame.comps:
        n = c.bw_alloc * c.bh_alloc
        if frame.lossless:
            plane = frame.samples[c.offset:c.offset + n].reshape(c.bh_alloc, c.bw_alloc)
        else:
            plane = idct_plane(coefs[c.offset:c.offset + n], c.quant, c.bh_alloc, c.bw_alloc)
        planes.append(upsample(plane, c.dw, c.dh, frame.hmax // c.h, frame.vmax // c.v,
                               frame.width, frame.height, not frame.lossless))
    return planes


def _pixels_plain(frame, coefs, mode: int) -> np.ndarray:
    planes = _planes(frame, coefs)
    if len(planes) == 1:
        return planes[0]
    if mode == YCC:
        return ycc_to_rgb(*planes)
    if mode == YCCK:
        out = ycck_to_cmyk(*planes)
    else:
        out = np.stack(planes, -1)
    return 255 - out if len(planes) == 4 else out  # Pillow's rawmode CMYK;I


def _pixels_native(frame, coefs, mode: int) -> np.ndarray:
    n = len(frame.comps)
    out = np.empty((frame.height, frame.width, n) if n > 1 else (frame.height, frame.width),
                   np.uint8)
    params = [frame.width, frame.height, n, mode, int(frame.lossless)]
    for c in frame.comps:
        params += [c.bw_alloc, c.bh_alloc, c.offset, c.dw, c.dh, frame.hmax // c.h,
                   frame.vmax // c.v]
    quant = np.stack([c.quant for c in frame.comps]).astype(np.int32)
    data = frame.samples if frame.lossless else coefs
    rc = _lib().sailor_torch_jpeg_pixels(
        data.ctypes.data_as(ctypes.c_void_p), _i32(quant), _i32(np.asarray(params, np.int32)),
        _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError("JPEG pixel pass failed")
    return out


# ---------------------------------------------------------------- markers

def decode_jpeg(data: bytes, *, plain: bool = False) -> np.ndarray:
    """JPEG bytes -> the array ``imageio.v2.imread`` gives (module
    docstring). ``plain`` runs the Python entropy decoders and the numpy
    smoothing and pixel passes in place of the C++ library. A malformed
    file raises ValueError("JPEG: ..."), a refused one
    NotImplementedError."""
    try:
        frame, mode = _read(bytes(data), plain)
        coefs = None
        if not frame.lossless:
            coefs = frame.coefs
            if frame.progressive and _smoothed(frame):
                coefs = (_smooth_plain if plain else _smooth_native)(frame)
        return (_pixels_plain if plain else _pixels_native)(frame, coefs, mode)
    except (ValueError, IndexError, struct.error) as e:  # truncated fields too
        raise ValueError(f"JPEG: {e or 'truncated file'}") from e


def _read(data: bytes, plain: bool):
    """Parse the markers and entropy-decode every scan: (the frame with its
    coefficients or samples, its colour conversion)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    quant: dict[int, np.ndarray] = {}
    tables: tuple[dict, dict] = ({}, {})
    cond = [[0] * 16, [1] * 16, [5] * 16]  # DAC: L and U by DC table, Kx by AC table
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
        elif marker == 0xCC:
            _read_dac(seg, cond)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame = _Frame(marker, seg)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame")
            pos = _read_scan(data, pos, seg, frame, quant, tables, cond, restart, plain)
        # other segments (APPn, COM, DNL after a frame of known height) are skipped
    if frame is None:
        raise ValueError("JPEG without a frame")
    for c in frame.comps:
        if c.quant is None:
            raise ValueError(f"JPEG component {c.cid} appears in no scan")
    for c in frame.comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise NotImplementedError(
                f"fractional JPEG sampling {c.h}x{c.v} of {frame.hmax}x{frame.vmax}")
    # jdapimin.c default_decompress_parms: JFIF, then Adobe, then the ids
    ids = [c.cid for c in frame.comps]
    if len(ids) == 4:
        mode = YCCK if adobe and adobe_transform != 0 else CMYK
    elif len(ids) != 3:
        mode = GREY_OR_RGB
    elif jfif:
        mode = YCC
    elif adobe:
        mode = GREY_OR_RGB if adobe_transform == 0 else YCC
    else:  # R, G, B; a lossless file's unmarked components too (libjpeg-turbo 3)
        mode = GREY_OR_RGB if frame.lossless or ids == [82, 71, 66] else YCC
    if frame.lossless and mode in (YCC, YCCK):
        raise NotImplementedError("lossless JPEG files in YCbCr or YCCK are not supported "
                                  "(libjpeg-turbo refuses the lossy colour conversion)")
    return frame, mode


def _read_scan(data, pos, seg, frame, quant, tables, cond, restart, plain) -> int:
    """Check one SOS header, decode its scan; the index after the scan."""
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
            if frame.lossless:
                c.quant = np.ones(64, np.int32)  # no quantisation
            elif c.tq not in quant:
                raise ValueError(f"JPEG quantisation table {c.tq} is not defined")
            else:
                c.quant = quant[c.tq]
        scomps.append((ci, td >> 4, td & 15))
    if ns > 1 and sum(frame.comps[ci].h * frame.comps[ci].v for ci, _, _ in scomps) > 10:
        raise ValueError("JPEG MCU of more than 10 blocks")  # jdinput.c's limit
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if frame.lossless:
        if not 1 <= ss <= 7 or se or ah or al > 7:
            raise ValueError(f"invalid lossless JPEG scan: predictor {ss}, Se={se}, Al={al}")
    elif not frame.progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss and ns != 1) or al > 13:
        raise ValueError(f"invalid progressive JPEG scan Ss={ss} Se={se} Al={al}")
    if not frame.arith:  # the Huffman tables libjpeg checks: those the scan reads
        for ci, d, a in scomps:
            used = [(0, d)] if frame.lossless or (ss == 0 and ah == 0) else []
            if not frame.lossless and (ss or not frame.progressive):
                used.append((1, a))
            for cls, slot in used:
                if slot not in tables[cls]:
                    raise ValueError("JPEG scan uses an undefined Huffman table")
                tables[cls][slot].check(dc=cls == 0, lossless=frame.lossless)
    if not frame.lossless:
        for ci, _, _ in scomps:
            bits = frame.comps[ci].coef_bits
            for k in range(ss, se + 1):
                bits[k] = al
    if frame.lossless:
        scan = _scan_lossless_plain if plain else _scan_lossless_native
    elif frame.arith:
        scan = _scan_arith_plain if plain else _scan_arith_native
    else:
        scan = _scan_plain if plain else _scan_native
    return scan(data, pos, frame, scomps, cond if frame.arith else tables, ss, se, ah, al,
                restart)


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


def _read_dac(seg: bytes, cond) -> None:
    """DAC: the conditioning of DC table Tb (L in the low nibble, U in the
    high one) or of AC table Tb (Kx), by Tc << 4 | Tb."""
    if len(seg) % 2:
        raise ValueError("malformed JPEG DAC segment")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32:
            raise ValueError(f"JPEG DAC names table {index}")
        if index >= 16:
            cond[2][index - 16] = val
        else:
            cond[0][index], cond[1][index] = val & 15, val >> 4
            if cond[0][index] > cond[1][index]:
                raise ValueError(f"JPEG DAC bounds L > U ({val:#x})")


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
