// Host image decoding for the texture importers (utils/jpeg.py, utils/gif.py):
// the serial parts of JPEG and GIF decoding, which run too slowly in Python.
//
//   sailor_torch_jpeg_scan           one JPEG scan's Huffman decoding into the
//                                    frame's coefficient blocks (baseline and
//                                    progressive: DC/AC first and refinement
//                                    scans, end-of-band runs, restart
//                                    intervals)
//   sailor_torch_jpeg_scan_arith     the same for an arithmetic-coded scan
//                                    (SOF9, SOF10), as libjpeg-turbo's
//                                    jdarith.c decodes it
//   sailor_torch_jpeg_scan_lossless  a lossless (SOF3) scan's differences,
//                                    undone by its predictor into samples
//   sailor_torch_jpeg_smooth         libjpeg-turbo's progressive block
//                                    smoothing (jdcoefct.c)
//   sailor_torch_jpeg_pixels         ISLOW IDCT, fancy upsampling and the
//                                    YCbCr->RGB, CMYK and YCCK conversions as
//                                    libjpeg-turbo and Pillow do them
//   sailor_torch_gif_lzw             a GIF image's LZW code stream -> colour
//                                    indices
//
// Each is held bit for bit to its plain Python version in utils/jpeg.py and
// utils/gif.py. A C interface, loaded with ctypes (kernels/host_lib.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t marker = -1;

  uint32_t byte() {
    if (marker >= 0 || pos >= n) return 0;
    uint8_t b = d[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    int64_t q = pos + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q < n && d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    marker = pos;
    return 0;
  }
  void fill(int need) {
    while (nbits < need) {
      acc = (acc << 8) | byte();
      nbits += 8;
    }
  }
  int bit() {
    fill(1);
    --nbits;
    return int((acc >> nbits) & 1);
  }
  int get(int k) {
    if (k == 0) return 0;
    fill(k);
    nbits -= k;
    return int((acc >> nbits) & ((1u << k) - 1));
  }
  int peek(int k) {
    fill(k);
    return int((acc >> (nbits - k)) & ((1u << k) - 1));
  }
  int extend(int s) {
    if (s == 0) return 0;
    int v = get(s);
    return v >= (1 << (s - 1)) ? v : v - (1 << s) + 1;
  }
};

int64_t next_marker(const uint8_t* d, int64_t n, int64_t pos) {
  while (true) {
    while (pos < n && d[pos] != 0xFF) ++pos;
    if (pos + 1 >= n) return n;
    int64_t q = pos + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q < n && d[q] != 0) return q - 1;
    pos = q;
  }
}

void restart(Bits& b) {
  b.acc = 0;
  b.nbits = 0;
  int64_t pos = b.marker >= 0 ? b.marker : next_marker(b.d, b.n, b.pos);
  if (pos + 1 < b.n && b.d[pos + 1] >= 0xD0 && b.d[pos + 1] <= 0xD7) {
    b.pos = pos + 2;
    b.marker = -1;
  } else {
    b.pos = pos;
    b.marker = pos;
  }
}

constexpr int kLook = 9;

struct Huff {
  int maxcode[18], valptr[17], mincode[17];
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol, 0 when longer than kLook

  // false for a table libjpeg refuses (jdhuff.c, JERR_BAD_HUFF_TABLE):
  // counts that overfill the code space or give a code of all ones, or a
  // DC symbol above max_dc (15; 16 for lossless differences)
  bool build(const int32_t* t, bool is_dc, int max_dc = 15) {
    for (int i = 0; i < 256; ++i) vals[i] = uint8_t(t[16 + i]);
    int code = 0, k = 0;
    std::fill(maxcode, maxcode + 18, -1);
    std::fill(valptr, valptr + 17, 0);
    std::fill(mincode, mincode + 17, 0);
    std::fill(look, look + (1 << kLook), 0);
    for (int len = 1; len <= 16; ++len) {
      int cnt = t[len - 1];
      if (cnt < 0 || code + cnt >= (1 << len) || k + cnt > 256) return false;
      if (cnt) {
        valptr[len] = k;
        mincode[len] = code;
        for (int i = 0; i < cnt && len <= kLook; ++i) {
          int c = code + i, span = 1 << (kLook - len);
          for (int j = 0; j < span; ++j)
            look[(c << (kLook - len)) | j] = uint16_t((len << 8) | vals[(k + i) & 255]);
        }
        code += cnt;
        k += cnt;
        maxcode[len] = code - 1;
      }
      code <<= 1;
    }
    for (int i = 0; i < k; ++i)
      if (is_dc && vals[i] > max_dc) return false;
    return true;
  }
  int decode(Bits& b) const {
    int e = look[b.peek(kLook)];
    if (e) {
      b.nbits -= e >> 8;
      return e & 255;
    }
    int code = 0;
    for (int len = 1; len <= 16; ++len) {
      code = (code << 1) | b.bit();
      if (code <= maxcode[len]) return vals[(valptr[len] + code - mincode[len]) & 255];
    }
    return 0;
  }
};

inline int16_t i16(int64_t v) { return int16_t(uint16_t(uint64_t(v))); }

struct ScanComp {
  int h, v, bw, bh, bw_alloc, offset, dc, ac;
};

int refine_ac(Bits& b, int16_t* blk, const Huff& t, int ss, int se, int al, int eobrun) {
  int p1 = 1 << al, m1 = -(1 << al);
  int k = ss;
  if (eobrun == 0) {
    while (k <= se) {
      int rs = t.decode(b);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = b.bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun = (1 << r) + (r ? b.get(r) : 0);
        break;
      }
      while (k <= se) {
        int c = blk[k];
        if (c) {
          if (b.bit() && !(c & p1)) blk[k] = i16(c + (c >= 0 ? p1 : m1));
        } else if (--r < 0) {
          break;
        }
        ++k;
      }
      if (s) blk[std::min(k, 63)] = i16(s);
      ++k;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int c = blk[k];
      if (c && b.bit() && !(c & p1)) blk[k] = i16(c + (c >= 0 ? p1 : m1));
    }
    --eobrun;
  }
  return eobrun;
}

// ------------------------------------------------------------ arithmetic coding

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next MPS << 8 |
// switch << 7 | next LPS; the last entry is the fixed estimate of 0.5
constexpr uint32_t V(uint32_t qe, uint32_t lps, uint32_t mps, uint32_t sw) {
  return qe << 16 | mps << 8 | sw << 7 | lps;
}
constexpr uint32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};

// jdarith.c's arith_decode over the bytes Bits::byte() gives (stuffing
// undone, zeros at a marker)
struct Arith {
  Bits& b;
  int64_t c = 0, a = 0;
  int ct = -16;  // read two bytes before the first decision

  explicit Arith(Bits& bits) : b(bits) {}
  void reset() {
    c = a = 0;
    ct = -16;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | b.byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // two bytes in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAritab[sv & 0x7F];
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t qe = e >> 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// A nonzero AC value once bin p (3 (k - 1) + 1) said nonzero: sign,
// magnitude category (twice at p + 1, then from 189 or 217 by Kx) and
// bits. false on a magnitude overflow.
bool arith_ac_value(Arith& d, uint8_t* st, uint8_t* fixed, int p, int k, int kx, int* out) {
  int sign = d.decode(fixed);
  ++p;
  int m = d.decode(st + p);
  if (m && d.decode(st + p)) {
    m = 2;
    p = k <= kx ? 189 : 217;
    while (d.decode(st + p)) {
      if ((m <<= 1) == 0x8000) return false;
      ++p;
    }
  }
  int v = m;
  p += 14;
  while (m >>= 1)
    if (d.decode(st + p)) v |= m;
  *out = sign ? -(v + 1) : v + 1;
  return true;
}

// coefficients ss..se of one block (decode_mcu's AC, decode_mcu_AC_first)
bool arith_ac(Arith& d, uint8_t* st, uint8_t* fixed, int16_t* blk, int ss, int se, int al,
              int kx) {
  for (int k = ss; k <= se; ++k) {
    int p = 3 * (k - 1);
    if (d.decode(st + p)) break;  // end of block
    while (!d.decode(st + p + 1)) {
      p += 3;
      if (++k > se) return false;
    }
    int v;
    if (!arith_ac_value(d, st, fixed, p + 1, k, kx, &v)) return false;
    blk[k] = i16(int64_t(v) * (int64_t(1) << al));
  }
  return true;
}

bool arith_refine_ac(Arith& d, uint8_t* st, uint8_t* fixed, int16_t* blk, int ss, int se,
                     int al) {
  int p1 = 1 << al, m1 = -(1 << al);
  int kex = se;
  while (kex > 0 && !blk[kex]) --kex;
  for (int k = ss; k <= se; ++k) {
    int p = 3 * (k - 1);
    if (k > kex && d.decode(st + p)) break;
    for (;;) {
      int c = blk[k];
      if (c) {
        if (d.decode(st + p + 2)) blk[k] = i16(c + (c < 0 ? m1 : p1));
        break;
      }
      if (d.decode(st + p + 1)) {
        blk[k] = i16(d.decode(fixed) ? m1 : p1);
        break;
      }
      p += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// The blocks of MCU m of a scan: a one-component scan walks that
// component's own blocks, an interleaved one the MCU grid.
void mcu_blocks(const ScanComp* sc, int ns, int mcux, int64_t m,
                std::vector<std::pair<int, int64_t>>& mcu) {
  mcu.clear();
  if (ns == 1) {
    int64_t y = m / sc[0].bw, x = m % sc[0].bw;
    mcu.push_back({0, sc[0].offset + y * sc[0].bw_alloc + x});
    return;
  }
  int64_t my = m / mcux, mx = m % mcux;
  for (int si = 0; si < ns; ++si)
    for (int by = 0; by < sc[si].v; ++by)
      for (int bx = 0; bx < sc[si].h; ++bx)
        mcu.push_back({si, sc[si].offset + (my * sc[si].v + by) * sc[si].bw_alloc
                               + mx * sc[si].h + bx});
}

// ------------------------------------------------------------ block smoothing

// one estimate of decompress_smooth_data: the kernel over the 5 x 5 DC
// values, rounded by the quantiser q, capped below 2^al when al > 0
int smooth_estimate(const int64_t* dc, const int32_t* kern, int64_t q00, int64_t q, int al) {
  int64_t num = 0;
  for (int i = 0; i < 25; ++i) num += dc[i] * kern[i];
  num *= q00;
  int64_t pred = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
  return int(num < 0 ? -pred : pred);
}

// ------------------------------------------------------------ IDCT (jidctint.c)

constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline void idct_1d(const int64_t* x, int stride, int64_t* out, int ostride, int shift) {
  int64_t z1 = (x[2 * stride] + x[6 * stride]) * F0541;
  int64_t tmp2 = z1 + x[6 * stride] * -F1847;
  int64_t tmp3 = z1 + x[2 * stride] * F0765;
  int64_t tmp0 = (x[0] + x[4 * stride]) * (1 << 13);
  int64_t tmp1 = (x[0] - x[4 * stride]) * (1 << 13);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7 * stride], t1 = x[5 * stride], t2 = x[3 * stride], t3 = x[1 * stride];
  int64_t a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  int64_t z5 = (a3 + a4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  a1 *= -F0899;
  a2 *= -F2562;
  a3 = a3 * -F1961 + z5;
  a4 = a4 * -F0390 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  int64_t half = int64_t(1) << (shift - 1);
  int64_t v[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                  tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int i = 0; i < 8; ++i) out[i * ostride] = (v[i] + half) >> shift;
}

constexpr int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                              12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                              35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                              58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// (bh * bw, 64) zigzag blocks -> the (bh * 8) x (bw * 8) plane.
void idct_plane(const int16_t* coefs, const int32_t* q, int bw, int bh, uint8_t* plane) {
  int64_t blk[64], ws[64], px[64];
  int64_t stride = int64_t(bw) * 8;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const int16_t* c = coefs + (int64_t(by) * bw + bx) * 64;
      for (int k = 0; k < 64; ++k) blk[kNatural[k]] = int64_t(c[k]);
      for (int k = 0; k < 64; ++k) blk[k] *= q[k];
      for (int col = 0; col < 8; ++col) idct_1d(blk + col, 8, ws + col, 8, 11);
      for (int row = 0; row < 8; ++row) idct_1d(ws + row * 8, 1, px + row * 8, 1, 18);
      uint8_t* o = plane + int64_t(by) * 8 * stride + int64_t(bx) * 8;
      for (int row = 0; row < 8; ++row)
        for (int col = 0; col < 8; ++col)
          o[row * stride + col] = uint8_t(std::clamp<int64_t>(px[row * 8 + col] + 128, 0, 255));
    }
  }
}

// A component plane (real samples [:dh, :dw], row stride ps) -> H x W,
// written with pixel stride ostep (jdsample.c's fancy and box upsamplers;
// box only unless fancy).
void upsample(const uint8_t* p, int64_t ps, int dw, int dh, int rh, int rv, int W, int H,
              uint8_t* out, int ostep, bool fancy) {
  auto P = [&](int y, int x) -> int {
    return p[int64_t(std::clamp(y, 0, dh - 1)) * ps + std::clamp(x, 0, dw - 1)];
  };
  auto put = [&](int y, int x, int v) {
    if (y < H && x < W) out[(int64_t(y) * W + x) * ostep] = uint8_t(v);
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) put(y, x, P(y, x));
  } else if (!fancy) {  // a lossless file: box replication
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) put(y, x, P(y / rv, x / rh));
  } else if (rv == 1 && rh == 2 && dw > 2) {
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < dw; ++x) {
        int c = 3 * P(y, x);
        put(y, 2 * x, (c + P(y, x - 1) + 1) >> 2);
        put(y, 2 * x + 1, (c + P(y, x + 1) + 2) >> 2);
      }
  } else if (rh == 1 && rv == 2) {
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < dw; ++x) {
        int c = 3 * P(y, x);
        put(2 * y, x, (c + P(y - 1, x) + 1) >> 2);
        put(2 * y + 1, x, (c + P(y + 1, x) + 2) >> 2);
      }
  } else if (rh == 2 && rv == 2 && dw > 2) {
    std::vector<int> row(dw);
    for (int y = 0; y < dh; ++y)
      for (int half = 0; half < 2; ++half) {
        int oy = 2 * y + half;
        if (oy >= H) break;
        int ny = half ? y + 1 : y - 1;
        for (int x = 0; x < dw; ++x) row[x] = 3 * P(y, x) + P(ny, x);
        for (int x = 0; x < dw; ++x) {
          int c = 3 * row[x];
          put(oy, 2 * x, (c + row[std::max(x - 1, 0)] + 8) >> 4);
          put(oy, 2 * x + 1, (c + row[std::min(x + 1, dw - 1)] + 7) >> 4);
        }
      }
  } else {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) put(y, x, P(y / rv, x / rh));
  }
}

// the scan's components from the params of sailor_torch_jpeg_scan*;
// false when there are not 1-4 or a table slot is outside 0-15
bool scan_comps(const int32_t* params, ScanComp* sc) {
  int ns = params[8];
  if (ns < 1 || ns > 4) return false;
  for (int i = 0; i < ns; ++i) {
    const int32_t* p = params + 10 + 8 * i;
    sc[i] = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
    if (sc[i].dc < 0 || sc[i].dc > 15 || sc[i].ac < 0 || sc[i].ac > 15) return false;
  }
  return true;
}

int64_t scan_mcus(const int32_t* params, const ScanComp* sc) {
  return params[8] == 1 ? int64_t(sc[0].bw) * sc[0].bh : int64_t(params[6]) * params[7];
}

}  // namespace

extern "C" {

// params: ss, se, ah, al, restart, progressive, mcux, mcuy, ncomp, blocks (of
// coefs), then per scan component h, v, bw, bh, bw_alloc, offset (blocks), dc
// table, ac table.
// tables: (2 classes, 4 slots, 16 counts + 256 symbols). coefs: (blocks, 64)
// zigzag. Returns the index of the marker after the scan, or -1 when a table
// the scan reads is one libjpeg refuses (Huff::build) or a block lies outside
// coefs.
int64_t sailor_torch_jpeg_scan(const uint8_t* data, int64_t n, int64_t pos,
                               const int32_t* params, const int32_t* tables, int16_t* coefs) {
  int ss = params[0], se = params[1], ah = params[2], al = params[3], ri = params[4];
  bool prog = params[5] != 0;
  int mcux = params[6], ns = params[8];
  int64_t nblocks = params[9];
  ScanComp sc[4];
  if (!scan_comps(params, sc)) return -1;
  Huff dc[4], ac[4];
  // the tables the scan reads, which are the ones libjpeg checks
  bool use_dc = !prog || (ss == 0 && ah == 0), use_ac = !prog || ss > 0;
  for (int i = 0; i < ns; ++i) {
    if (sc[i].dc > 3 || sc[i].ac > 3) return -1;
    if ((use_dc && !dc[i].build(tables + (0 * 4 + sc[i].dc) * 272, true))
        || (use_ac && !ac[i].build(tables + (1 * 4 + sc[i].ac) * 272, false)))
      return -1;
  }
  Bits b{data, n, pos};
  int64_t pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int64_t nmcu = scan_mcus(params, sc);
  std::vector<std::pair<int, int64_t>> mcu;
  for (int64_t m = 0; m < nmcu; ++m) {
    if (ri && m && m % ri == 0) {
      restart(b);
      std::fill(pred, pred + 4, 0);
      eobrun = 0;
    }
    mcu_blocks(sc, ns, mcux, m, mcu);
    for (auto [si, blkno] : mcu) {
      if (blkno < 0 || blkno >= nblocks) return -1;
      int16_t* blk = coefs + blkno * 64;
      if (!prog) {
        pred[si] += b.extend(dc[si].decode(b));
        blk[0] = i16(pred[si]);
        for (int k = 1; k < 64; ++k) {
          int rs = ac[si].decode(b);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[std::min(k, 63)] = i16(b.extend(s));
          } else if (r != 15) {
            break;
          } else {
            k += 15;
          }
        }
      } else if (ss == 0 && ah == 0) {
        pred[si] += b.extend(dc[si].decode(b));
        blk[0] = i16(pred[si] * (int64_t(1) << al));
      } else if (ss == 0) {
        if (b.bit()) blk[0] = i16(blk[0] | (1 << al));
      } else if (ah == 0) {
        if (eobrun) {
          --eobrun;
          continue;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = ac[si].decode(b);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[std::min(k, 63)] = i16(int64_t(b.extend(s)) * (int64_t(1) << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) + (r ? b.get(r) : 0) - 1;
            break;
          }
        }
      } else {
        eobrun = refine_ac(b, blk, ac[si], ss, se, al, eobrun);
      }
    }
  }
  return b.marker >= 0 ? b.marker : next_marker(data, n, b.pos);
}

// The same params as sailor_torch_jpeg_scan; cond: the DAC conditioning,
// L[16], U[16] (by DC table) and Kx[16] (by AC table). Statistics and the
// DC predictors start at zero and are reset at each restart marker.
// Returns the index of the marker after the scan, or -1 for bad params.
int64_t sailor_torch_jpeg_scan_arith(const uint8_t* data, int64_t n, int64_t pos,
                                     const int32_t* params, const int32_t* cond,
                                     int16_t* coefs) {
  int ss = params[0], se = params[1], ah = params[2], al = params[3], ri = params[4];
  bool prog = params[5] != 0;
  int mcux = params[6], ns = params[8];
  int64_t nblocks = params[9];
  ScanComp sc[4];
  if (!scan_comps(params, sc)) return -1;
  bool use_dc = !prog || (ss == 0 && ah == 0), use_ac = !prog || ss > 0;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed = 113;
  int64_t last[4];
  int ctx[4];
  auto fresh = [&]() {
    for (int i = 0; i < ns; ++i) {
      if (use_dc) std::memset(dc_stats[sc[i].dc], 0, 64);
      if (use_ac) std::memset(ac_stats[sc[i].ac], 0, 256);
      last[i] = ctx[i] = 0;
    }
  };
  fresh();
  Bits b{data, n, pos};
  Arith d(b);
  bool broken = false;
  int64_t nmcu = scan_mcus(params, sc);
  std::vector<std::pair<int, int64_t>> mcu;
  for (int64_t m = 0; m < nmcu; ++m) {
    if (ri && m && m % ri == 0) {
      restart(b);
      d.reset();
      fresh();
      broken = false;
    }
    if (broken) continue;  // libjpeg decodes nothing more until the next restart
    mcu_blocks(sc, ns, mcux, m, mcu);
    for (auto [si, blkno] : mcu) {
      if (blkno < 0 || blkno >= nblocks) return -1;
      int16_t* blk = coefs + blkno * 64;
      uint8_t* ac = ac_stats[sc[si].ac];
      if (use_dc) {
        int t = sc[si].dc;
        uint8_t* st = dc_stats[t];
        int s0 = ctx[si];
        if (d.decode(st + s0) == 0) {
          ctx[si] = 0;
        } else {
          int sign = d.decode(st + s0 + 1);
          int p = s0 + 2 + sign;
          int mag = d.decode(st + p);
          if (mag) {
            p = 20;
            while (d.decode(st + p)) {
              if ((mag <<= 1) == 0x8000) break;
              ++p;
            }
          }
          if (mag == 0x8000) {
            broken = true;
            break;
          }
          if (mag < (1 << cond[t]) >> 1)
            ctx[si] = 0;
          else if (mag > (1 << cond[16 + t]) >> 1)
            ctx[si] = 12 + 4 * sign;
          else
            ctx[si] = 4 + 4 * sign;
          int v = mag;
          p += 14;
          for (int bit = mag >> 1; bit; bit >>= 1)
            if (d.decode(st + p)) v |= bit;
          ++v;
          last[si] = (last[si] + (sign ? -v : v)) & 0xFFFF;
        }
        blk[0] = i16(last[si] << al);
        if (!prog && !arith_ac(d, ac, &fixed, blk, 1, 63, 0, cond[32 + sc[si].ac])) {
          broken = true;
          break;
        }
      } else if (ss == 0) {
        if (d.decode(&fixed)) blk[0] = i16(blk[0] | (1 << al));
      } else if (ah == 0) {
        broken = !arith_ac(d, ac, &fixed, blk, ss, se, al, cond[32 + sc[si].ac]);
      } else {
        broken = !arith_refine_ac(d, ac, &fixed, blk, ss, se, al);
      }
    }
  }
  return b.marker >= 0 ? b.marker : next_marker(data, n, b.pos);
}

// params: MCU rows, MCUs a row, MCU rows per restart interval (0: none),
// predictor (1-7), Al, ncomp in the scan, MCU rows an iMCU row, then per
// scan component its offset and row stride in samples, its samples in an
// MCU across and down (h, v; 1, 1 in a one-component scan) and its real
// width and height. tables: (ncomp, 16 counts + 256 symbols), the DC
// tables. samples: the frame's nsamples uint8 samples. An iMCU row is
// decoded, then undone (jddiffct.c): a restart marker anywhere in it makes
// its first row predict from the left. Returns the index of the marker
// after the scan, or -1 for a table libjpeg refuses or a row outside
// samples.
int64_t sailor_torch_jpeg_scan_lossless(const uint8_t* data, int64_t n, int64_t pos,
                                        const int32_t* params, const int32_t* tables,
                                        uint8_t* samples, int64_t nsamples) {
  int rows = params[0], cols = params[1], rpr = params[2], pred = params[3], al = params[4];
  int ns = params[5], group = params[6];
  if (ns < 1 || ns > 4 || pred < 1 || pred > 7 || al < 0 || al > 7 || cols < 1 || group < 1)
    return -1;
  struct Comp {
    int64_t off, stride;
    int h, v, w, ht;
  } sc[4];
  Huff tab[4];
  std::vector<int64_t> diff[4], prev[4];
  for (int i = 0; i < ns; ++i) {
    const int32_t* p = params + 7 + 6 * i;
    sc[i] = {p[0], p[1], p[2], p[3], p[4], p[5]};
    if (sc[i].h < 1 || sc[i].v < 1 || sc[i].w < 1 || sc[i].ht < 1 || sc[i].off < 0
        || sc[i].stride < sc[i].w || sc[i].w > int64_t(cols) * sc[i].h
        || sc[i].off + (int64_t(sc[i].ht) - 1) * sc[i].stride + sc[i].w > nsamples)
      return -1;
    if (!tab[i].build(tables + 272 * i, true, 16)) return -1;
    diff[i].assign(size_t(group) * sc[i].v * cols * sc[i].h, 0);
  }
  std::vector<int64_t> cur;
  Bits b{data, n, pos};
  bool first[4] = {true, true, true, true};
  for (int top = 0; top < rows; top += group) {
    for (int my = top; my < std::min(top + group, rows); ++my) {
      if (rpr && my && my % rpr == 0) {
        restart(b);
        std::fill(first, first + 4, true);  // for this whole iMCU row
      }
      for (int mx = 0; mx < cols; ++mx)
        for (int si = 0; si < ns; ++si)
          for (int by = 0; by < sc[si].v; ++by)
            for (int bx = 0; bx < sc[si].h; ++bx) {
              int s = tab[si].decode(b);
              size_t row = size_t(my - top) * sc[si].v + by;
              diff[si][row * cols * sc[si].h + size_t(mx) * sc[si].h + bx] =
                  s == 16 ? 32768 : b.extend(s);
            }
    }
    for (int si = 0; si < ns; ++si) {
      const Comp& c = sc[si];
      cur.assign(size_t(c.w), 0);
      for (int r = 0; r < group * c.v; ++r) {
        int64_t y = int64_t(top) * c.v + r;
        if (y >= c.ht) break;  // the dummy rows of the last MCU row
        const int64_t* dd = diff[si].data() + size_t(r) * cols * c.h;
        const int64_t* up = prev[si].data();
        for (int x = 0; x < c.w; ++x) {
          int64_t p;
          if (first[si]) {
            p = x ? cur[x - 1] : int64_t(1) << (7 - al);
          } else if (x == 0) {
            p = up[0];
          } else {
            int64_t ra = cur[x - 1], rb = up[x], rc = up[x - 1];
            switch (pred) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
          }
          cur[x] = (dd[x] + p) & 0xFFFF;
        }
        uint8_t* out = samples + c.off + y * c.stride;
        for (int x = 0; x < c.w; ++x) out[x] = uint8_t(cur[x] << al);
        prev[si] = cur;
        first[si] = false;
      }
    }
  }
  return b.marker >= 0 ? b.marker : next_marker(data, n, b.pos);
}

// params: iMCU rows, ncomp, then per component bw, bh (real blocks),
// bw_alloc, bh_alloc, offset (blocks), v, coef_bits of zigzag 0-9. quant:
// (ncomp, 64) natural order. kernels: (20, 5, 5), for zigzag 1-9 then the
// DC: the kernel with AC data and the one with DC data only. out: a copy
// of coefs to smooth (decompress_smooth_data, jdcoefct.c). Returns 0.
int sailor_torch_jpeg_smooth(const int16_t* coefs, const int32_t* quant, const int32_t* params,
                             const int32_t* kernels, int16_t* out) {
  int total_rows = params[0], nc = params[1];
  if (nc < 1 || nc > 4) return -1;
  for (int ci = 0; ci < nc; ++ci) {
    const int32_t* p = params + 2 + 16 * ci;
    int bw = p[0], bh = p[1], bw_alloc = p[2], v = p[5];
    const int32_t* bits = p + 6;
    const int32_t* q = quant + 64 * ci;
    int64_t off = p[4];
    bool only_dc = true;
    for (int k = 1; k < 10; ++k) only_dc = only_dc && bits[k] == -1;
    for (int y = 0; y < bh; ++y) {
      // the rows libjpeg takes as two above and two below, by its
      // per-iMCU-row count
      int i = y / v, r = y % v;
      int block_rows = i < total_rows - 1 ? v : (bh % v ? bh % v : v);
      int ibr = i * block_rows + r, ibrs = block_rows * total_rows;
      int prev = ibr > 0 ? y - 1 : y, next = ibr < ibrs - 1 ? y + 1 : y;
      int rows[5] = {ibr > 1 ? y - 2 : prev, prev, y, next, ibr < ibrs - 2 ? y + 2 : next};
      for (int x = 0; x < bw; ++x) {
        int64_t dc[25];
        for (int a = 0; a < 5; ++a)
          for (int c = 0; c < 5; ++c) {
            int xc = std::clamp(x + c - 2, 0, bw - 1);
            dc[5 * a + c] = coefs[(off + int64_t(rows[a]) * bw_alloc + xc) * 64];
          }
        int16_t* blk = out + (off + int64_t(y) * bw_alloc + x) * 64;
        for (int k = 1; k < 10; ++k) {
          if (bits[k] == 0 || blk[k] != 0 || (!only_dc && k > 5)) continue;
          blk[k] = int16_t(smooth_estimate(dc, kernels + 25 * (2 * (k - 1) + only_dc), q[0],
                                           q[kNatural[k]], bits[k]));
        }
        if (only_dc) blk[0] = int16_t(smooth_estimate(dc, kernels + 25 * 19, q[0], q[0], 0));
      }
    }
  }
  return 0;
}

// params: W, H, ncomp, colour mode (0 none, 1 YCbCr->RGB, 2 CMYK, 3 YCCK),
// lossless, then per component bw_alloc, bh_alloc, offset, dw, dh, rh, rv.
// data: (blocks, 64) int16 zigzag coefficients, or for a lossless frame
// the uint8 sample planes (offset and sizes in samples). quant: (ncomp,
// 64) natural order. out: H x W x ncomp; 4 components come out inverted,
// as Pillow's rawmode CMYK;I reads them.
int sailor_torch_jpeg_pixels(const void* data, const int32_t* quant, const int32_t* params,
                             uint8_t* out) {
  int W = params[0], H = params[1], nc = params[2], mode = params[3];
  bool lossless = params[4] != 0;
  if (nc != 1 && nc != 3 && nc != 4) return -1;
  std::vector<uint8_t> up(size_t(W) * H * nc);
  for (int c = 0; c < nc; ++c) {
    const int32_t* p = params + 5 + 7 * c;
    int bw = p[0], bh = p[1];
    if (lossless) {
      const uint8_t* plane = static_cast<const uint8_t*>(data) + p[2];
      upsample(plane, bw, p[3], p[4], p[5], p[6], W, H, up.data() + c, nc, false);
      continue;
    }
    std::vector<uint8_t> plane(size_t(bw) * 8 * bh * 8);
    idct_plane(static_cast<const int16_t*>(data) + int64_t(p[2]) * 64, quant + 64 * c, bw, bh,
               plane.data());
    upsample(plane.data(), int64_t(bw) * 8, p[3], p[4], p[5], p[6], W, H, up.data() + c, nc,
             true);
  }
  size_t npx = size_t(W) * H;
  if (nc == 1 || mode == 0) {
    std::memcpy(out, up.data(), up.size());
  } else {
    // jdcolor.c: SCALEBITS 16, ONE_HALF folded into the green Cb table
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    auto fix = [](double v) { return int64_t(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + (1 << 15)) >> 16);
      cb_b[i] = int((fix(1.77200) * x + (1 << 15)) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + (1 << 15);
    }
    for (size_t i = 0; i < npx; ++i) {
      const uint8_t* s = up.data() + nc * i;
      uint8_t* o = out + nc * i;
      int y = s[0], cb = s[1], cr = s[2];
      if (mode == 2) {
        std::memcpy(o, s, nc);
        continue;
      }
      int rgb[3] = {std::clamp(y + cr_r[cr], 0, 255),
                    int(std::clamp<int64_t>(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)),
                    std::clamp(y + cb_b[cb], 0, 255)};
      for (int k = 0; k < 3; ++k) o[k] = uint8_t(mode == 3 ? 255 - rgb[k] : rgb[k]);
      if (nc == 4) o[3] = s[3];  // YCCK's K passes through
    }
  }
  if (nc == 4)
    for (size_t i = 0; i < npx * 4; ++i) out[i] = uint8_t(255 - out[i]);
  return 0;
}

// data: the image's LZW sub-blocks joined; out: npix indices. Codes start
// at min_code + 1 bits and grow to 12; a clear code resets the table, the
// end code stops; at 4096 entries the table stays full until a clear code
// (the deferred clear). Returns the pixels written; a code that is not yet
// in the table ends the image early.
int64_t sailor_torch_gif_lzw(const uint8_t* data, int64_t n, int min_code, uint8_t* out,
                             int64_t npix) {
  if (min_code < 1 || min_code > 11) return -1;
  const int clear = 1 << min_code, eoi = clear + 1;
  std::vector<int16_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> len(4096);
  for (int i = 0; i < clear; ++i) {
    suffix[i] = first[i] = uint8_t(i);
    len[i] = 1;
  }
  int width = min_code + 1, next = clear + 2, prev = -1;
  int64_t o = 0, bitpos = 0, nbits = n * 8;
  while (o < npix && bitpos + width <= nbits) {
    int code = 0;
    for (int i = 0; i < width; ++i, ++bitpos)
      code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << i;
    if (code == clear) {
      width = min_code + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int emit;
    if (prev < 0) {
      if (code >= clear) break;
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < 4096) {
        prefix[next] = int16_t(prev);
        suffix[next] = first[code];
        first[next] = first[prev];
        len[next] = uint16_t(len[prev] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = int16_t(prev);
      suffix[next] = first[prev];
      first[next] = first[prev];
      len[next] = uint16_t(len[prev] + 1);
      emit = next++;
    } else {
      break;
    }
    int l = len[emit];
    int64_t end = o + l;
    for (int c = emit, i = l - 1; i >= 0; --i, c = prefix[c])
      if (o + i < npix) out[o + i] = suffix[c];
    o = std::min(end, npix);
    prev = emit;
    if (next == (1 << width) && width < 12) ++width;
  }
  return o;
}

}  // extern "C"
