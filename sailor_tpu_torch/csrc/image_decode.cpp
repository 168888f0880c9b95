// Host image decoding for the texture importers (utils/jpeg.py, utils/gif.py):
// the serial parts of JPEG and GIF decoding, which run too slowly in Python.
//
//   sailor_torch_jpeg_scan    one JPEG scan's Huffman decoding into the
//                             frame's coefficient blocks (baseline and
//                             progressive: DC/AC first and refinement scans,
//                             end-of-band runs, restart intervals)
//   sailor_torch_jpeg_pixels  ISLOW IDCT, fancy upsampling and YCbCr->RGB
//                             as libjpeg-turbo does them at its defaults
//   sailor_torch_gif_lzw      a GIF image's LZW code stream -> colour indices
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
  // DC symbol above 15
  bool build(const int32_t* t, bool is_dc) {
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
      if (is_dc && vals[i] > 15) return false;
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
// written with pixel stride ostep (jdsample.c's fancy and box upsamplers).
void upsample(const uint8_t* p, int64_t ps, int dw, int dh, int rh, int rv, int W, int H,
              uint8_t* out, int ostep) {
  auto P = [&](int y, int x) -> int {
    return p[int64_t(std::clamp(y, 0, dh - 1)) * ps + std::clamp(x, 0, dw - 1)];
  };
  auto put = [&](int y, int x, int v) {
    if (y < H && x < W) out[(int64_t(y) * W + x) * ostep] = uint8_t(v);
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) put(y, x, P(y, x));
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
  int mcux = params[6], mcuy = params[7], ns = params[8];
  int64_t nblocks = params[9];
  if (ns < 1 || ns > 4) return -1;
  ScanComp sc[4];
  Huff dc[4], ac[4];
  // the tables the scan reads, which are the ones libjpeg checks
  bool use_dc = !prog || (ss == 0 && ah == 0), use_ac = !prog || ss > 0;
  for (int i = 0; i < ns; ++i) {
    const int32_t* p = params + 10 + 8 * i;
    sc[i] = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
    if (sc[i].dc < 0 || sc[i].dc > 3 || sc[i].ac < 0 || sc[i].ac > 3) return -1;
    if ((use_dc && !dc[i].build(tables + (0 * 4 + sc[i].dc) * 272, true))
        || (use_ac && !ac[i].build(tables + (1 * 4 + sc[i].ac) * 272, false)))
      return -1;
  }
  Bits b{data, n, pos};
  int64_t pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int64_t nmcu = ns == 1 ? int64_t(sc[0].bw) * sc[0].bh : int64_t(mcux) * mcuy;
  std::vector<std::pair<int, int64_t>> mcu;
  for (int64_t m = 0; m < nmcu; ++m) {
    if (ri && m && m % ri == 0) {
      restart(b);
      std::fill(pred, pred + 4, 0);
      eobrun = 0;
    }
    mcu.clear();
    if (ns == 1) {
      int64_t y = m / sc[0].bw, x = m % sc[0].bw;
      mcu.push_back({0, sc[0].offset + y * sc[0].bw_alloc + x});
    } else {
      int64_t my = m / mcux, mx = m % mcux;
      for (int si = 0; si < ns; ++si)
        for (int by = 0; by < sc[si].v; ++by)
          for (int bx = 0; bx < sc[si].h; ++bx)
            mcu.push_back({si, sc[si].offset + (my * sc[si].v + by) * sc[si].bw_alloc
                                   + mx * sc[si].h + bx});
    }
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

// params: W, H, ncomp, rgb, then per component bw_alloc, bh_alloc, offset,
// dw, dh, rh, rv. quant: (ncomp, 64) natural order. out: H x W x ncomp.
int sailor_torch_jpeg_pixels(const int16_t* coefs, const int32_t* quant, const int32_t* params,
                             uint8_t* out) {
  int W = params[0], H = params[1], nc = params[2];
  bool rgb = params[3] != 0;
  if (nc != 1 && nc != 3) return -1;
  std::vector<uint8_t> up(size_t(W) * H * nc);
  for (int c = 0; c < nc; ++c) {
    const int32_t* p = params + 4 + 7 * c;
    int bw = p[0], bh = p[1];
    std::vector<uint8_t> plane(size_t(bw) * 8 * bh * 8);
    idct_plane(coefs + int64_t(p[2]) * 64, quant + 64 * c, bw, bh, plane.data());
    upsample(plane.data(), int64_t(bw) * 8, p[3], p[4], p[5], p[6], W, H, up.data() + c, nc);
  }
  if (nc == 1 || rgb) {
    std::memcpy(out, up.data(), up.size());
    return 0;
  }
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
  size_t npx = size_t(W) * H;
  for (size_t i = 0; i < npx; ++i) {
    int y = up[3 * i], cb = up[3 * i + 1], cr = up[3 * i + 2];
    out[3 * i] = uint8_t(std::clamp(y + cr_r[cr], 0, 255));
    out[3 * i + 1] = uint8_t(std::clamp<int64_t>(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255));
    out[3 * i + 2] = uint8_t(std::clamp(y + cb_b[cb], 0, 255));
  }
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
