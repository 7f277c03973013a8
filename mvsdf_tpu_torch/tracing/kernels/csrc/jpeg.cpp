// Baseline JPEG decoder for the scene loaders and the Vis-MVSNet converter.
//
// Reads sequential Huffman-coded 8-bit JPEG (SOF0, SOF1) with 1 or 3
// components, sampling factors up to 2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0),
// restart intervals, several scans, and skips APPn and COM segments.
// Rejects progressive, arithmetic-coded, lossless, hierarchical and 12-bit
// files, 2 or 4 components (CMYK, YCCK), other sampling ratios, and an EXIF
// orientation other than 1 (an image library would turn the image).
//
// The output equals libjpeg-turbo's with its default decompression
// settings, which image libraries use: the JDCT_ISLOW integer IDCT
// (jidctint.c), "fancy" triangle upsampling with its rounding biases
// (jdsample.c: h2v1, h2v2, h1v2; box replication where a subsampled row is
// at most 2 samples wide), and the fixed-point YCbCr -> RGB tables of
// jdcolor.c. Colour space as libjpeg infers it: JFIF means YCbCr, an Adobe
// marker's transform 0 means RGB, else component ids 'R','G','B' mean RGB,
// else YCbCr.
//
// C interface: jpeg_header() reports (height, width, channels) and
// jpeg_decode() writes the (H, W, C) uint8 image; both return 0, or 1 with
// a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

// ---- Huffman tables --------------------------------------------------------

const int kLookBits = 9;

struct Huff {
  bool set = false;
  uint8_t vals[256];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoff[17];     // vals index of a length's first code minus it
  uint16_t look[1 << kLookBits];  // (length << 8 | value), 0: not short

  void build(const uint8_t *bits, const uint8_t *v, int n) {
    memcpy(vals, v, n);
    memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      valoff[len] = k - code;
      if (bits[len]) {
        for (int i = 0; i < bits[len]; i++, k++, code++) {
          if (len <= kLookBits) {
            int shift = kLookBits - len;
            for (int j = 0; j < (1 << shift); j++)
              look[(code << shift) | j] = (uint16_t)(len << 8 | vals[k]);
          }
        }
        if (code - 1 >= (1 << len)) fail("bad Huffman table");
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    set = true;
  }
};

// ---- entropy-coded data ----------------------------------------------------

struct Bits {
  const uint8_t *d;
  size_t n, pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool marker = false;  // pos is at a marker: feed zeros, as libjpeg does

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int s) {  // the next s bits (1 <= s <= 16)
    if (cnt < s) fill();
    int v = (int)(acc >> (64 - s));
    acc <<= s;
    cnt -= s;
    return v;
  }
  int decode(const Huff &h) {
    if (cnt < 16) fill();
    uint16_t e = h.look[acc >> (64 - kLookBits)];
    if (e) {
      int len = e >> 8;
      acc <<= len;
      cnt -= len;
      return e & 0xFF;
    }
    int len = kLookBits + 1;
    int code = (int)(acc >> (64 - len));
    while (len <= 16 && code > h.maxcode[len]) {
      len++;
      code = (int)(acc >> (64 - len));
    }
    if (len > 16) fail("corrupt JPEG data: bad Huffman code");
    acc <<= len;
    cnt -= len;
    return h.vals[h.valoff[len] + code];
  }
  // Drop what is buffered and find the next marker; returns its code.
  int next_marker() {
    acc = 0;
    cnt = 0;
    marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
                            d[pos + 1] != 0xFF))
      pos++;
    if (pos + 1 >= n) fail("corrupt JPEG data: premature end of data");
    int m = d[pos + 1];
    pos += 2;
    return m;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- IDCT (jidctint.c, jpeg_idct_islow) ------------------------------------

const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// limit[x & 1023]: x + 128 clamped to [0, 255], as libjpeg's post-IDCT
// range-limit table (prepare_range_limit_table)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kLimit;

// coef: 64 dequantized coefficients in natural order -> 8x8 samples
void idct_islow(const int32_t *coef, uint8_t *out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int32_t *in = coef + c;
    int *w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = in[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    const int s = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kLimit.t[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kLimit.t[(int)descale(tmp10 + tmp3, s) & 1023];
    o[7] = kLimit.t[(int)descale(tmp10 - tmp3, s) & 1023];
    o[1] = kLimit.t[(int)descale(tmp11 + tmp2, s) & 1023];
    o[6] = kLimit.t[(int)descale(tmp11 - tmp2, s) & 1023];
    o[2] = kLimit.t[(int)descale(tmp12 + tmp1, s) & 1023];
    o[5] = kLimit.t[(int)descale(tmp12 - tmp1, s) & 1023];
    o[3] = kLimit.t[(int)descale(tmp13 + tmp0, s) & 1023];
    o[4] = kLimit.t[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// ---- the decoder -----------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled size (libjpeg's downsampled_*)
  int bw = 0, bh = 0;        // blocks allocated (whole MCUs)
  int stride = 0;
  std::vector<uint8_t> plane;
  bool decoded = false;
};

struct Decoder {
  const uint8_t *d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_set[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[3];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false, eoi = false;

  Decoder(const uint8_t *data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("corrupt JPEG data: premature end of data");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return hi << 8 | u8();
  }

  int next_marker() {
    // markers may be preceded by fill bytes 0xFF
    if (u8() != 0xFF) fail("corrupt JPEG data: expected a marker");
    int m = u8();
    while (m == 0xFF) m = u8();
    return m;
  }

  void read_app(int m, size_t end) {
    size_t len = end - pos;
    const uint8_t *p = d + pos;
    if (m == 0xE0 && len >= 5 && !memcmp(p, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (m == 0xE1 && len >= 14 && !memcmp(p, "Exif\0\0", 6)) exif(p + 6, len - 6);
  }

  void exif(const uint8_t *t, size_t len) {
    // TIFF header, IFD0; a malformed block is ignored
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> int {
      return le ? t[o] | t[o + 1] << 8 : t[o] << 8 | t[o + 1];
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)t[o] | (uint32_t)t[o + 1] << 8 |
                      (uint32_t)t[o + 2] << 16 | (uint32_t)t[o + 3] << 24
                : (uint32_t)t[o] << 24 | (uint32_t)t[o + 1] << 16 |
                      (uint32_t)t[o + 2] << 8 | (uint32_t)t[o + 3];
    };
    if (r16(2) != 42) return;
    uint32_t ifd = r32(4);
    if ((size_t)ifd + 2 > len) return;
    int count = r16(ifd);
    for (int i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > len) return;
      if (r16(e) == 0x0112) {
        int orient = r16(e + 8);
        if (r16(e + 2) == 3 && orient != 1) {
          char buf[96];
          snprintf(buf, sizeof(buf), "EXIF orientation %d is not read "
                   "(only 1, as stored)", orient);
          fail(buf);
        }
      }
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG data: bad quantization table");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      qt_set[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG data: bad Huffman table");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) total += bits[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end)
        fail("corrupt JPEG data: bad Huffman table");
      (tc ? ac : dc)[th].build(bits, d + pos, total);
      pos += total;
    }
  }

  void read_sof(int m) {
    if (frame) fail("corrupt JPEG data: two frames");
    switch (m) {
      case 0xC0: case 0xC1: break;
      case 0xC2: case 0xC6: fail("progressive JPEG is not read");
      case 0xC3: case 0xC7: fail("lossless JPEG is not read");
      case 0xC5: fail("hierarchical JPEG is not read");
      default: fail("arithmetic-coded JPEG is not read");
    }
    int precision = u8();
    if (precision != 8) {
      char buf[64];
      snprintf(buf, sizeof(buf), "%d-bit JPEG is not read", precision);
      fail(buf);
    }
    height = u16();
    width = u16();
    ncomp = u8();
    if (!height || !width) fail("JPEG without a height (DNL) is not read");
    if (ncomp != 1 && ncomp != 3) {
      char buf[96];
      snprintf(buf, sizeof(buf), "JPEG with %d components (CMYK/YCCK) is "
               "not read", ncomp);
      fail(buf);
    }
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = u8();
      int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8() & 3;
      if (comp[c].h < 1 || comp[c].v < 1 || comp[c].h > 4 || comp[c].v > 4)
        fail("corrupt JPEG data: bad sampling factors");
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    for (int c = 0; c < ncomp; c++) {
      if ((hmax % comp[c].h) || (vmax % comp[c].v) ||
          hmax / comp[c].h > 2 || vmax / comp[c].v > 2 ||
          (ncomp == 1 && (comp[c].h != hmax || comp[c].v != vmax)))
        fail("JPEG sampling factors other than 4:4:4, 4:2:2, 4:2:0 and "
             "4:4:0 are not read");
    }
    if (ncomp == 1) hmax = vmax = comp[0].h = comp[0].v = 1;
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component &k = comp[c];
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.bw = mcus_x * k.h;
      k.bh = mcus_y * k.v;
      k.stride = 8 * k.bw;
    }
    frame = true;
  }

  // Parses segments up to the first SOS (or EOI); returns that marker.
  int read_headers() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9 || m == 0xDA) return m;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t len = (size_t)u16();
      if (len < 2 || pos + len - 2 > n)
        fail("corrupt JPEG data: bad segment length");
      size_t end = pos + len - 2;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG is not read");
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m, end);
      }
      pos = end;
    }
  }

  void alloc() {
    for (int c = 0; c < ncomp; c++)
      comp[c].plane.assign((size_t)comp[c].stride * 8 * comp[c].bh, 0);
  }

  void decode_block(Bits &b, Component &k, const Huff &hd, const Huff &ha,
                    int &pred, int by, int bx) {
    int32_t coef[64];
    memset(coef, 0, sizeof(coef));
    int t = b.decode(hd);
    if (t > 15) fail("corrupt JPEG data: bad DC difference");
    int diff = t ? extend(b.get(t), t) : 0;
    pred += diff;
    const uint16_t *q = qt[k.tq];
    coef[0] = (int16_t)pred * q[0];
    for (int i = 1; i < 64; i++) {
      int rs = b.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail("corrupt JPEG data: coefficient past the block");
        int z = kNatural[i];
        coef[z] = (int16_t)extend(b.get(s), s) * q[z];
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    idct_islow(coef, k.plane.data() + (size_t)by * 8 * k.stride + 8 * bx,
               k.stride);
  }

  // Decodes the scan whose SOS segment starts at pos; returns the marker
  // after it.
  int read_scan() {
    if (!frame) fail("corrupt JPEG data: scan before the frame header");
    size_t len = (size_t)u16();
    size_t end = pos + len - 2;
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * (size_t)ns)
      fail("corrupt JPEG data: bad scan header");
    Component *sc[3];
    int td[3], ta[3];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail("corrupt JPEG data: scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].set || !ac[ta[i]].set)
        fail("corrupt JPEG data: scan uses an undefined Huffman table");
      if (!qt_set[sc[i]->tq])
        fail("corrupt JPEG data: undefined quantization table");
    }
    int ss = u8(), se = u8(), ahl = u8();
    if (ss != 0 || se != 63 || ahl != 0)
      fail("corrupt JPEG data: sequential scan with spectral selection");
    pos = end;
    for (int i = 0; i < ns; i++) sc[i]->decoded = true;

    Bits b{d, n, pos};
    int preds[3] = {0, 0, 0};
    int64_t mx, my;
    if (ns == 1) {
      mx = (sc[0]->dw + 7) / 8;
      my = (sc[0]->dh + 7) / 8;
    } else {
      mx = mcus_x;
      my = mcus_y;
    }
    int64_t total = mx * my, todo = restart;
    int rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart && todo == 0) {
        int mk = b.next_marker();
        if (mk != 0xD0 + rst)
          fail("corrupt JPEG data: missing restart marker");
        rst = (rst + 1) & 7;
        todo = restart;
        preds[0] = preds[1] = preds[2] = 0;
      }
      int64_t y = m / mx, x = m % mx;
      if (ns == 1) {
        decode_block(b, *sc[0], dc[td[0]], ac[ta[0]], preds[0], (int)y,
                     (int)x);
      } else {
        for (int i = 0; i < ns; i++) {
          Component &k = *sc[i];
          for (int v = 0; v < k.v; v++)
            for (int h = 0; h < k.h; h++)
              decode_block(b, k, dc[td[i]], ac[ta[i]], preds[i],
                           (int)(y * k.v + v), (int)(x * k.h + h));
        }
      }
      todo--;
    }
    int mk = b.next_marker();
    pos = b.pos;
    return mk;
  }

  void decode_all() {
    int m = read_headers();
    if (!frame) fail("corrupt JPEG data: no frame header");
    alloc();
    while (m == 0xDA) {
      m = read_scan();
      // segments between scans (tables, restart interval)
      while (m != 0xDA && m != 0xD9) {
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
          m = next_marker();
          continue;
        }
        size_t len = (size_t)u16();
        if (len < 2 || pos + len - 2 > n)
          fail("corrupt JPEG data: bad segment length");
        size_t end = pos + len - 2;
        if (m == 0xC4) read_dht(end);
        else if (m == 0xDB) read_dqt(end);
        else if (m == 0xDD) restart = u16();
        else if (m >= 0xC0 && m <= 0xCF && m != 0xC8)
          fail("corrupt JPEG data: a second frame");
        pos = end;
        m = next_marker();
      }
    }
    for (int c = 0; c < ncomp; c++)
      if (!comp[c].decoded) fail("corrupt JPEG data: a component has no scan");
  }

  // The component's samples at full size (height x width), upsampled as
  // libjpeg-turbo's jdsample.c does.
  std::vector<uint8_t> full_plane(const Component &k) {
    const int W = width, H = height;
    std::vector<uint8_t> out((size_t)W * H);
    const int rh = hmax / k.h, rv = vmax / k.v;
    const uint8_t *p = k.plane.data();
    const int s = k.stride, dw = k.dw, dh = k.dh;
    auto row = [&](int y) {  // clamped: libjpeg duplicates the edge rows
      return p + (size_t)(y < 0 ? 0 : y >= dh ? dh - 1 : y) * s;
    };
    std::vector<uint8_t> tmp(2 * (size_t)dw + 2);
    for (int y = 0; y < H; y++) {
      uint8_t *o = out.data() + (size_t)y * W;
      if (rh == 1 && rv == 1) {
        memcpy(o, row(y), W);
      } else if (rh == 2 && rv == 1) {
        const uint8_t *in = row(y);
        if (dw > 2) {  // h2v1_fancy_upsample
          uint8_t *t = tmp.data();
          t[0] = in[0];
          t[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < dw - 1; i++) {
            int v = in[i] * 3;
            t[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
            t[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
          }
          t[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          t[2 * dw - 1] = in[dw - 1];
          memcpy(o, t, W);
        } else {
          for (int x = 0; x < W; x++) o[x] = in[x >> 1];
        }
      } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
        const uint8_t *in0 = row(y >> 1);
        const uint8_t *in1 = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; x++)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {  // rh == 2 && rv == 2
        const uint8_t *in0 = row(y >> 1);
        if (dw > 2) {  // h2v2_fancy_upsample
          const uint8_t *in1 = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
          uint8_t *t = tmp.data();
          int this_ = in0[0] * 3 + in1[0];
          int next = in0[1] * 3 + in1[1];
          t[0] = (uint8_t)((this_ * 4 + 8) >> 4);
          t[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
          int last = this_;
          this_ = next;
          for (int i = 1; i < dw - 1; i++) {
            next = in0[i + 1] * 3 + in1[i + 1];
            t[2 * i] = (uint8_t)((this_ * 3 + last + 8) >> 4);
            t[2 * i + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
          }
          t[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
          t[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
          memcpy(o, t, W);
        } else {
          for (int x = 0; x < W; x++) o[x] = in0[x >> 1];
        }
      }
    }
    return out;
  }

  bool rgb_space() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  void output(uint8_t *out) {
    if (ncomp == 1) {
      std::vector<uint8_t> y = full_plane(comp[0]);
      memcpy(out, y.data(), y.size());
      return;
    }
    std::vector<uint8_t> p0 = full_plane(comp[0]), p1 = full_plane(comp[1]),
                         p2 = full_plane(comp[2]);
    const size_t np = (size_t)width * height;
    if (rgb_space()) {
      for (size_t i = 0; i < np; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static bool built = false;
    if (!built) {
      const int64_t one_half = (int64_t)1 << 15;
      auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
      for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + one_half;
      }
      built = true;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < np; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// hwc[0..2] = height, width, channels (1 or 3) of the JPEG in data.
int jpeg_header(const uint8_t *data, int64_t size, int32_t *hwc, char *err,
                int errlen) {
  try {
    Decoder dec(data, (size_t)size);
    int m = dec.read_headers();
    if (!dec.frame) fail(m == 0xD9 ? "JPEG without an image"
                                   : "corrupt JPEG data: scan before the "
                                     "frame header");
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.ncomp;
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
}

// Decodes the JPEG in data into out, (height, width, channels) uint8 of
// out_size bytes, as jpeg_header() gives them.
int jpeg_decode(const uint8_t *data, int64_t size, uint8_t *out,
                int64_t out_size, char *err, int errlen) {
  try {
    Decoder dec(data, (size_t)size);
    dec.decode_all();
    if ((int64_t)dec.height * dec.width * dec.ncomp != out_size)
      fail("output buffer of the wrong size");
    dec.output(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc &) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
