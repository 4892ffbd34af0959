// Image decoding for the data pipeline: baseline, extended sequential and
// progressive JPEG, and the pixel half of PNG (unfiltering, de-interlacing
// and conversion to RGB; the zlib stream is inflated by the caller).  Plain
// C interface, bound with ctypes (data/image_io.py), so a call runs without
// the interpreter lock.
//
// JPEG: SOF0/SOF1 and progressive SOF2 (Huffman), 8-bit samples, 1, 3 or 4
// components, sampling 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2), 8- and 16-bit
// quantization tables, up to four Huffman tables of each class, restart
// intervals, and scans that are interleaved or hold one component each.
// The arithmetic is libjpeg's default decompression path, so the pixels
// equal PIL's ``Image.open(path).convert("RGB")``, which decodes with that
// library:
// - progressive scans (jdphuff.c): DC first and refine, AC first and
//   refine with end-of-band runs and correction bits, into a buffer of
//   coefficients that the inverse DCT reads once every scan is in;
// - the integer "islow" inverse DCT (jidctint.c), including its output
//   range limit, which wraps a sample outside [-512, 511] as the library's
//   table does;
// - "fancy" triangle-filter upsampling of subsampled components
//   (jdsample.c, h2v1_fancy_upsample and h2v2_fancy_upsample; a component
//   at most two samples wide is replicated instead, as the library does),
//   with the component's first and last rows standing in for the rows
//   beyond them;
// - the colour space the library infers (jdapimin.c): YCbCr or, by the
//   Adobe APP14 transform 0 or the component ids 'R' 'G' 'B', RGB for three
//   components; CMYK, or YCCK with Adobe transform 2, for four;
// - fixed-point YCbCr to RGB and YCCK to CMYK with 16 fraction bits
//   (jdcolor.c).
// A grey image is replicated into three channels, as convert("RGB") does.
// Four components are read as PIL reads them, as inverted (Adobe) CMYK,
// and converted with PIL's cmyk2rgb.  A progressive file whose scans leave
// some of the first ten coefficients of a component incomplete is
// block-smoothed as libjpeg-turbo 3.1 smooths it (jdcoefct.c,
// decompress_smooth_data; see smooth_component).  Lossless, hierarchical
// and arithmetic-coded files and 12-bit samples are refused, with a message
// naming what is refused.
//
// PNG: filter types 0-4, sequential or Adam7-interlaced, over 1-, 2-, 4-, 8-
// and 16-bit grey, 8- and 16-bit grey+alpha, RGB and RGBA, and 1-, 2-, 4- and
// 8-bit palette images; alpha is dropped, sub-byte grey is scaled to
// 0..255, 16-bit grey is clipped to 255 (PIL opens it as I;16) and the
// other 16-bit types keep their high byte, as convert("RGB") does.
//
// Every function returns 0 on success, or 1 with a message in ``err``.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& what) : std::runtime_error(what) {}
};

int report(const char* what, char* err, int errlen) {
  if (err != nullptr && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", what);
  }
  return 1;
}

// Zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries, so a run that overshoots position 63 in corrupt data lands there.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const long kMaxPixels = 1L << 28;  // a larger image is refused, not allocated

// ---------------------------------------------------------------- Huffman

struct Huffman {
  bool present = false;
  // Canonical decoding (jdhuff.c's derived table): for a code of length l,
  // code <= maxcode[l] decodes to vals[code + valoffset[l]].
  int maxcode[17];
  int valoffset[17];
  uint8_t vals[256];
  // 9-bit lookahead: length (0 = longer code) and symbol.
  uint8_t look_len[512];
  uint8_t look_sym[512];

  void build(const uint8_t counts[16], const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, static_cast<size_t>(nsym));
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; ++l) {
      int n = counts[l - 1];
      if (n) {
        valoffset[l] = k - code;
        for (int i = 0; i < n; ++i, ++k, ++code) {
          if (code >= (1 << l)) throw Error("bad Huffman table (DHT): too many codes");
          if (l <= 9) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); ++j) {
              look_len[(code << shift) | j] = static_cast<uint8_t>(l);
              look_sym[(code << shift) | j] = symbols[k];
            }
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    present = true;
  }
};

// ------------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;  // p points at a marker; zeros are fed from here

  void fill() {
    while (nbits <= 56) {
      unsigned b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          unsigned next = (p + 1 < end) ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {  // n in 1..16
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    int look = static_cast<int>(acc >> (64 - 9));
    int len = h.look_len[look];
    if (len) {
      acc <<= len;
      nbits -= len;
      return h.look_sym[look];
    }
    int l = 10;
    int code = static_cast<int>(acc >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) throw Error("corrupt JPEG data: bad Huffman code");
      code = static_cast<int>(acc >> (64 - l));
    }
    acc <<= l;
    nbits -= l;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  void reset() {
    acc = 0;
    nbits = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------------- JPEG

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks held (padded to whole MCUs)
  int dsw = 0, dsh = 0;  // downsampled width and height in samples
  int dc_pred = 0;
  // The quantization table, latched at the component's first scan as
  // libjpeg does (jdinput.c, latch_quant_tables).
  // A component in no scan keeps zeros, as libjpeg's multipliers do.
  bool latched = false;
  uint16_t quant[64] = {};
  // Progressive: the Al of the last scan that held coefficient k (natural
  // order is not needed: libjpeg tracks zigzag positions 0..9), -1 before
  // any scan did.
  int coef_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
};

// What a scan adds to each block: sequential, or one of the four kinds of
// progressive scan (jdphuff.c).
enum class ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool progressive = false;
  bool seen_jfif = false, seen_adobe = false;
  int adobe_transform = -1;
  uint16_t quant[4][64];
  bool quant_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // The scan being decoded.
  int ss = 0, se = 63, al = 0;
  int eobrun = 0;

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

  unsigned u8() {
    if (pos >= size) throw Error("truncated JPEG");
    return data[pos++];
  }
  unsigned u16() {
    unsigned hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // Skip to the next 0xFF, then past fill bytes.
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) throw Error("truncated JPEG: no EOI marker");
    return data[pos++];
  }

  void read_sof(int marker) {
    size_t len = u16();
    size_t start = pos;
    int precision = static_cast<int>(u8());
    if (precision != 8) {
      throw Error(std::to_string(precision) + "-bit JPEG samples (SOF" +
                  std::to_string(marker - 0xC0) + ") are not supported");
    }
    height = static_cast<int>(u16());
    width = static_cast<int>(u16());
    ncomp = static_cast<int>(u8());
    if (height == 0) throw Error("JPEG with height 0 (DNL) is not supported");
    if (width == 0) throw Error("JPEG with width 0");
    if (static_cast<long>(width) * height > kMaxPixels) throw Error("JPEG too large");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      throw Error(std::to_string(ncomp) + "-component JPEG is not supported");
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = static_cast<int>(u8());
      unsigned hv = u8();
      c.h = static_cast<int>(hv >> 4);
      c.v = static_cast<int>(hv & 15);
      c.tq = static_cast<int>(u8());
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Error("bad sampling factors (SOF)");
      if (c.tq > 3) throw Error("bad quantization table id (SOF)");
    }
    if (pos - start + 2 != len) throw Error("bad SOF length");
  }

  void read_dqt() {
    size_t len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      unsigned pq_tq = u8();
      unsigned pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("bad DQT");
      for (int k = 0; k < 64; ++k) {
        quant[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      }
      quant_present[tq] = true;
    }
    if (pos != end) throw Error("bad DQT length");
  }

  void read_dht() {
    size_t len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      unsigned tc_th = u8();
      unsigned tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = static_cast<uint8_t>(u8());
        total += counts[i];
      }
      if (total > 256) throw Error("bad DHT: more than 256 symbols");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = static_cast<uint8_t>(u8());
      (tc ? ac[th] : dc[th]).build(counts, symbols, total);
    }
    if (pos != end) throw Error("bad DHT length");
  }

  void read_app(int marker) {
    size_t len = u16();
    if (len < 2 || pos + len - 2 > size) throw Error("truncated JPEG segment");
    const uint8_t* s = data + pos;
    if (marker == 0xE0 && len >= 7 && std::memcmp(s, "JFIF\0", 5) == 0) seen_jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(s, "Adobe", 5) == 0) {
      seen_adobe = true;
      adobe_transform = s[11];
    }
    pos += len - 2;
  }

  void skip_segment() {
    size_t len = u16();
    if (len < 2 || pos + len - 2 > size) throw Error("truncated JPEG segment");
    pos += len - 2;
  }

  // Parse up to and including the frame header; leaves pos after SOF.
  void read_header() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Error("not a JPEG (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        progressive = m == 0xC2;
        read_sof(m);
        return;
      }
      if (m == 0xC3) throw Error("lossless JPEG (SOF3) is not supported");
      if ((m >= 0xC5 && m <= 0xC7) || m == 0xCD || m == 0xCE || m == 0xCF ||
          m == 0xC9 || m == 0xCA || m == 0xCB) {
        char buf[96];
        std::snprintf(buf, sizeof(buf), "JPEG frame type SOF%d (marker 0xFF%02X) is not supported",
                      m - 0xC0, m);
        throw Error(buf);
      }
      if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDD) {
        u16();
        restart_interval = static_cast<int>(u16());
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xD9 || m == 0xDA) {
        throw Error("JPEG has no frame header (SOF)");
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // standalone marker
      } else {
        skip_segment();
      }
    }
  }

  // The colour space libjpeg infers (jdapimin.c, default_decompress_parms).
  bool rgb_coded() const {
    if (ncomp != 3) return false;
    if (seen_jfif) return false;
    if (seen_adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
  bool ycck_coded() const { return ncomp == 4 && seen_adobe && adobe_transform != 0; }

  void setup_components() {
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (ncomp > 1) {
        int rh = hmax / c.h, rv = vmax / c.v;
        bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                  ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
        if (!ok) {
          throw Error("JPEG chroma sampling other than 4:4:4, 4:2:2 and 4:2:0 is not supported");
        }
      }
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dsw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dsh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
  }

  void decode_block(Bits& bits, Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int t = bits.decode(hd);
    if (t > 11) throw Error("corrupt JPEG data: bad DC size");
    int diff = t ? extend(bits.get(t), t) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = bits.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Error("corrupt JPEG data: coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // jdphuff.c, decode_mcu_DC_first: one block's DC difference, scaled by Al.
  void dc_first(Bits& bits, Component& c, int16_t* blk) {
    int t = bits.decode(dc[c.td]);
    if (t > 11) throw Error("corrupt JPEG data: bad DC size");
    c.dc_pred += t ? extend(bits.get(t), t) : 0;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
  }

  // decode_mcu_DC_refine: one more bit of the DC.
  void dc_refine(Bits& bits, int16_t* blk) {
    if (bits.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  // decode_mcu_AC_first: the band's first bits, with end-of-band runs.
  void ac_first(Bits& bits, Component& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& ha = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = bits.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(bits.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits.get(r);
        --eobrun;
        break;
      }
    }
  }

  // A correction bit for an already nonzero coefficient.
  void refine(Bits& bits, int16_t* coef) {
    if (bits.get(1) && (*coef & (1 << al)) == 0) {
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + (1 << al) : *coef - (1 << al));
    }
  }

  // decode_mcu_AC_refine: newly nonzero coefficients of +-2^Al, and a
  // correction bit for every coefficient that was already nonzero.
  void ac_refine(Bits& bits, Component& c, int16_t* blk) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      const Huffman& ha = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = bits.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : -p1;  // the size is 1 in a valid file
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;  // the rest of the block is the end-of-band run's
        }
        do {
          int16_t* coef = &blk[kNatural[k]];
          if (*coef != 0) {
            refine(bits, coef);
          } else if (--r < 0) {
            break;  // the zero coefficient that the new value takes
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef != 0) refine(bits, coef);
      }
      --eobrun;
    }
  }

  void decode_unit(ScanKind kind, Bits& bits, Component& c, int16_t* blk) {
    switch (kind) {
      case ScanKind::kSequential: decode_block(bits, c, blk); break;
      case ScanKind::kDcFirst: dc_first(bits, c, blk); break;
      case ScanKind::kDcRefine: dc_refine(bits, blk); break;
      case ScanKind::kAcFirst: ac_first(bits, c, blk); break;
      case ScanKind::kAcRefine: ac_refine(bits, c, blk); break;
    }
  }

  // Consume an RSTn marker after a restart interval, and reset what the
  // interval carries: the DC predictions and the end-of-band run.
  void restart(Bits& bits) {
    bits.reset();
    bits.at_marker = false;
    const uint8_t* p = bits.p;
    for (;;) {
      while (p < bits.end && *p != 0xFF) ++p;
      while (p < bits.end && *p == 0xFF) ++p;
      if (p >= bits.end) throw Error("truncated JPEG: missing RST marker");
      unsigned m = *p++;
      if (m >= 0xD0 && m <= 0xD7) break;
      if (m != 0x00) throw Error("corrupt JPEG data: expected an RST marker");
    }
    bits.p = p;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    eobrun = 0;
  }

  // The kind of a scan from its Ss, Se, Ah and Al, checked as libjpeg does
  // (jdphuff.c, start_pass_phuff_decoder).
  ScanKind scan_kind(int ns, int ah) {
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        throw Error("JPEG scan is not sequential (SOS Ss/Se/Ah/Al)");
      }
      return ScanKind::kSequential;
    }
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) throw Error("bad progression parameters in a progressive JPEG scan (SOS)");
    if (ss == 0) return ah == 0 ? ScanKind::kDcFirst : ScanKind::kDcRefine;
    return ah == 0 ? ScanKind::kAcFirst : ScanKind::kAcRefine;
  }

  void read_scan() {
    size_t len = u16();
    size_t start = pos;
    int ns = static_cast<int>(u8());
    if (ns < 1 || ns > ncomp) throw Error("bad SOS component count");
    Component* sc[4];
    int tables[4];
    for (int i = 0; i < ns; ++i) {
      int id = static_cast<int>(u8());
      tables[i] = static_cast<int>(u8());
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (c == nullptr) throw Error("SOS names an unknown component");
      sc[i] = c;
    }
    ss = static_cast<int>(u8());
    se = static_cast<int>(u8());
    unsigned ahal = u8();
    al = static_cast<int>(ahal & 15);
    ScanKind kind = scan_kind(ns, static_cast<int>(ahal >> 4));
    if (pos - start + 2 != len) throw Error("bad SOS length");
    // The Huffman tables the scan reads: a DC refinement reads none.
    bool need_dc = kind == ScanKind::kSequential || kind == ScanKind::kDcFirst;
    bool need_ac = kind == ScanKind::kSequential || kind == ScanKind::kAcFirst ||
                   kind == ScanKind::kAcRefine;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      c.td = tables[i] >> 4;
      c.ta = tables[i] & 15;
      if ((need_dc && (c.td > 3 || !dc[c.td].present)) ||
          (need_ac && (c.ta > 3 || !ac[c.ta].present))) {
        throw Error("SOS uses a Huffman table that was not defined (DHT)");
      }
      if (!c.latched) {
        if (!quant_present[c.tq]) throw Error("component uses an undefined quantization table (DQT)");
        std::memcpy(c.quant, quant[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      for (int k = ss; k <= std::min(se, 9); ++k) c.coef_bits[k] = al;
    }
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    eobrun = 0;

    Bits bits;
    bits.p = data + pos;
    bits.end = data + size;
    int interval = 0;
    if (ns == 1) {
      // One component: its own block grid, not the padded MCU grid.
      Component& c = *sc[0];
      int nbx = (c.dsw + 7) / 8, nby = (c.dsh + 7) / 8;
      for (int by = 0; by < nby; ++by) {
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart_interval && interval == restart_interval) {
            restart(bits);
            interval = 0;
          }
          decode_unit(kind, bits, c, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
          ++interval;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && interval == restart_interval) {
            restart(bits);
            interval = 0;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y) {
              for (int x = 0; x < c.h; ++x) {
                size_t b = static_cast<size_t>(my * c.v + y) * c.bw + (mx * c.h + x);
                decode_unit(kind, bits, c, &c.coef[b * 64]);
              }
            }
          }
          ++interval;
        }
      }
    }
    pos = static_cast<size_t>(bits.p - data);
  }

  // libjpeg smooths the blocks of a progressive image (jdcoefct.c,
  // smoothing_ok) when every component has its DC and nonzero quantizers
  // at the ten positions the smoothing reads, and some component's first
  // nine AC coefficients are incomplete or missing after the last scan.
  bool smoothing_ok() const {
    static const int kQuantPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int q : kQuantPos) {
        if (c.quant[q] == 0) return false;
      }
      for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  void read_scans() {
    setup_components();
    int scans = 0;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        read_scan();
        ++scans;
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDD) {
        u16();
        restart_interval = static_cast<int>(u16());
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // stray restart marker between scans
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        throw Error("JPEG with a second frame header is not supported");
      } else {
        skip_segment();
      }
    }
    if (scans == 0) throw Error("JPEG has no scan (SOS)");
  }
};

// One estimated coefficient of block smoothing (jdcoefct.c): num over the
// quantizer q times 256, rounded, its magnitude capped below 2^Al when the
// coefficient is known to Al bits (Al > 0).
inline int16_t smooth_estimate(int64_t num, int64_t q, int al) {
  const bool negative = num < 0;
  int pred = static_cast<int>(((q << 7) + (negative ? -num : num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(negative ? -pred : pred);
}

// libjpeg-turbo 3.1's block smoothing of one component (jdcoefct.c,
// decompress_smooth_data), which PIL's decode runs on a progressive file
// whose scans leave some of the first ten coefficients incomplete.  Each
// block's first nine AC coefficients that are still zero and not known
// exactly are estimated from the DC values of the 5x5 blocks around it;
// when no AC scan reached the component at all (change_dc), the DC is
// re-estimated too and AC03, AC12, AC21 and AC30 join.  The coefficient
// states are those the last scan left (PIL decodes without buffered-image
// mode).  Edge blocks see their nearest neighbours repeated, as the
// library's sliding registers do; the rows beside a block are chosen by
// the library's own test on the iMCU row, which near the bottom may read a
// padding block row or repeat a row early.  Reads ``c.coef``, writes the
// blocks the library would pass to the inverse DCT into ``out``.
void smooth_component(const Component& c, int total_imcu_rows, std::vector<int16_t>& out) {
  const int* bits = c.coef_bits;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                         bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                         bits[9] == -1;
  const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                Q21 = c.quant[17], Q30 = c.quant[24];
  const int height_in_blocks = (c.dsh + 7) / 8, width_in_blocks = (c.dsw + 7) / 8;
  const int last_imcu = total_imcu_rows - 1, last_col = width_in_blocks - 1;
  auto block = [&](int row, int col) { return &c.coef[(static_cast<size_t>(row) * c.bw + col) * 64]; };
  for (int imcu = 0; imcu < total_imcu_rows; ++imcu) {
    int block_rows = c.v;
    if (imcu == last_imcu) {
      block_rows = height_in_blocks % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * total_imcu_rows;
    for (int br = 0; br < block_rows; ++br) {
      const int row = imcu * c.v + br;
      const int image_block_row = imcu * block_rows + br;
      const int prev = image_block_row > 0 ? row - 1 : row;
      const int prev_prev = image_block_row > 1 ? row - 2 : prev;
      const int next = image_block_row < image_block_rows - 1 ? row + 1 : row;
      const int next_next = image_block_row < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {prev_prev, prev, row, next, next_next};
      // dc[r][k]: the DC of row r at column col - 2 + k.
      int dc[5][5];
      for (int r = 0; r < 5; ++r) {
        for (int k = 0; k < 5; ++k) dc[r][k] = block(rows[r], 0)[0];
      }
      for (int col = 0; col <= last_col; ++col) {
        if (col == 0 && col < last_col) {
          for (int r = 0; r < 5; ++r) dc[r][3] = dc[r][4] = block(rows[r], 1)[0];
        }
        if (col + 1 < last_col) {
          for (int r = 0; r < 5; ++r) dc[r][4] = block(rows[r], col + 2)[0];
        }
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3], DC05 = dc[0][4];
        const int DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3], DC10 = dc[1][4];
        const int DC11 = dc[2][0], DC12 = dc[2][1], DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4];
        const int DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4];
        const int DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3], DC25 = dc[4][4];
        int16_t* ws = &out[(static_cast<size_t>(row) * c.bw + col) * 64];
        if (bits[1] != 0 && ws[1] == 0) {  // AC01
          ws[1] = smooth_estimate(
              Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                  3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                  3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                  DC24 + DC25)
                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
              Q01, bits[1]);
        }
        if (bits[2] != 0 && ws[8] == 0) {  // AC10
          ws[8] = smooth_estimate(
              Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                  13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                  38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                  3 * DC24 + DC25)
                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
              Q10, bits[2]);
        }
        if (bits[3] != 0 && ws[16] == 0) {  // AC20
          ws[16] = smooth_estimate(
              Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
              Q20, bits[3]);
        }
        if (bits[4] != 0 && ws[9] == 0) {  // AC11
          ws[9] = smooth_estimate(
              Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                  DC21 - DC25)
                               : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                  DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
              Q11, bits[4]);
        }
        if (bits[5] != 0 && ws[2] == 0) {  // AC02
          ws[2] = smooth_estimate(
              Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                  7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
              Q02, bits[5]);
        }
        if (change_dc) {
          if (bits[6] != 0 && ws[3] == 0) {  // AC03
            ws[3] = smooth_estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19),
                                    Q03, bits[6]);
          }
          if (bits[7] != 0 && ws[10] == 0) {  // AC12
            ws[10] = smooth_estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19),
                                     Q12, bits[7]);
          }
          if (bits[8] != 0 && ws[17] == 0) {  // AC21
            ws[17] = smooth_estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19),
                                     Q21, bits[8]);
          }
          if (bits[9] != 0 && ws[24] == 0) {  // AC30
            ws[24] = smooth_estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19),
                                     Q30, bits[9]);
          }
          ws[0] = smooth_estimate(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                     6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                     152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                     6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25),
              Q00, 0);
        }
        for (int r = 0; r < 5; ++r) {
          for (int k = 0; k < 4; ++k) dc[r][k] = dc[r][k + 1];
        }
      }
    }
  }
}

// jidctint.c (jpeg_idct_islow), 8-bit samples.
const int kConstBits = 13;
const int kPass1Bits = 2;
const long FIX_0_298631336 = 2446;
const long FIX_0_390180644 = 3196;
const long FIX_0_541196100 = 4433;
const long FIX_0_765366865 = 6270;
const long FIX_0_899976223 = 7373;
const long FIX_1_175875602 = 9633;
const long FIX_1_501321110 = 12299;
const long FIX_1_847759065 = 15137;
const long FIX_1_961570560 = 16069;
const long FIX_2_053119869 = 16819;
const long FIX_2_562915447 = 20995;
const long FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// The library's post-IDCT range limit: a sample x (centred on 0) indexes
// its table at x & 1023.
inline uint8_t idct_limit(long x) {
  int m = static_cast<int>(x & 1023);
  if (m < 128) return static_cast<uint8_t>(128 + m);
  if (m < 512) return 255;
  if (m < 896) return 0;
  return static_cast<uint8_t>(m - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = static_cast<int>(static_cast<long>(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    long z2 = static_cast<long>(ip[16]) * qp[16];
    long z3 = static_cast<long>(ip[48]) * qp[48];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * (-FIX_1_847759065);
    long tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<long>(ip[0]) * qp[0];
    z3 = static_cast<long>(ip[32]) * qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = static_cast<long>(ip[56]) * qp[56];
    tmp1 = static_cast<long>(ip[40]) * qp[40];
    tmp2 = static_cast<long>(ip[24]) * qp[24];
    tmp3 = static_cast<long>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const int n2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<long>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * (-FIX_1_847759065);
    long tmp3 = z1 + z2 * FIX_0_765366865;
    long tmp0 = (static_cast<long>(wp[0]) + wp[4]) * (1L << kConstBits);
    long tmp1 = (static_cast<long>(wp[0]) - wp[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, n2));
    op[7] = idct_limit(descale(tmp10 - tmp3, n2));
    op[1] = idct_limit(descale(tmp11 + tmp2, n2));
    op[6] = idct_limit(descale(tmp11 - tmp2, n2));
    op[2] = idct_limit(descale(tmp12 + tmp1, n2));
    op[5] = idct_limit(descale(tmp12 - tmp1, n2));
    op[3] = idct_limit(descale(tmp13 + tmp0, n2));
    op[4] = idct_limit(descale(tmp13 - tmp0, n2));
  }
}

// jdcolor.c's tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const long half = 1L << (kScale - 1);
    auto fix = [](double x) { return static_cast<long>(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;
  return tables;
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One output row of a component, upsampled to full width (>= width).
void upsample_row(const Component& c, const std::vector<uint8_t>& plane, int rh, int rv, int y,
                  uint8_t* out) {
  const int stride = c.bw * 8;
  const int n = c.dsw;
  if (rh == 1) {
    std::memcpy(out, &plane[static_cast<size_t>(y) * stride], static_cast<size_t>(n));
    return;
  }
  if (n <= 2) {  // the library replicates instead (no fancy filter)
    const uint8_t* in = &plane[static_cast<size_t>(rv == 2 ? y / 2 : y) * stride];
    for (int x = 0; x < n; ++x) out[2 * x] = out[2 * x + 1] = in[x];
    return;
  }
  if (rv == 1) {  // h2v1_fancy_upsample
    const uint8_t* in = &plane[static_cast<size_t>(y) * stride];
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < n - 1; ++x) {
      int v = in[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
    }
    out[2 * n - 2] = static_cast<uint8_t>((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
    out[2 * n - 1] = in[n - 1];
    return;
  }
  // h2v2_fancy_upsample: the nearer input row weighs 3, the further 1.
  int r = y / 2;
  int r1 = (y & 1) ? r + 1 : r - 1;
  if (r1 < 0) r1 = 0;
  if (r1 > c.dsh - 1) r1 = c.dsh - 1;
  const uint8_t* in0 = &plane[static_cast<size_t>(r) * stride];
  const uint8_t* in1 = &plane[static_cast<size_t>(r1) * stride];
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < n - 1; ++x) {
    next_sum = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * n - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * n - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

// PIL's MULDIV255 (ImagingCore's (a * b + 128) / 255, rounded its way).
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// ``as_rgb`` overrides the colour space libjpeg would infer for three
// components: 1 keeps them as stored (RGB), 0 converts them from YCbCr, -1
// infers (a TIFF's photometric tag decides, as libtiff tells libjpeg).
void jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                 int as_rgb = -1) {
  Jpeg j(data, size);
  j.read_header();
  if (j.width != width || j.height != height) throw Error("JPEG size differs from the header's");
  j.read_scans();

  const int nc = j.ncomp;
  const bool smooth = j.progressive && j.smoothing_ok();
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < nc; ++i) {
    Component& c = j.comp[i];
    std::vector<int16_t> smoothed;
    if (smooth) {
      smoothed = c.coef;
      smooth_component(c, j.mcuy, smoothed);
    }
    const std::vector<int16_t>& coef = smooth ? smoothed : c.coef;
    const int stride = c.bw * 8;
    planes[i].assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    // Only the blocks that hold samples of the image.
    int nby = (c.dsh + 7) / 8, nbx = (c.dsw + 7) / 8;
    for (int by = 0; by < nby; ++by) {
      for (int bx = 0; bx < nbx; ++bx) {
        idct_islow(&coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                   &planes[i][static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
    }
    std::vector<int16_t>().swap(c.coef);
  }

  const size_t row = static_cast<size_t>(width) * 3;
  if (nc == 1) {
    const Component& c = j.comp[0];
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = &planes[0][static_cast<size_t>(y) * c.bw * 8];
      uint8_t* o = out + y * row;
      for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  const YccTables& t = ycc_tables();
  const bool rgb = as_rgb < 0 ? j.rgb_coded() : as_rgb == 1, ycck = j.ycck_coded();
  std::vector<uint8_t> rows[4];
  int rh[4], rv[4];
  for (int i = 0; i < nc; ++i) {
    rh[i] = j.hmax / j.comp[i].h;
    rv[i] = j.vmax / j.comp[i].v;
    rows[i].assign(static_cast<size_t>(j.comp[i].dsw) * rh[i] + 16, 0);
  }
  for (int y = 0; y < height; ++y) {
    for (int i = 0; i < nc; ++i) upsample_row(j.comp[i], planes[i], rh[i], rv[i], y, rows[i].data());
    const uint8_t* c0 = rows[0].data();
    const uint8_t* c1 = rows[1].data();
    const uint8_t* c2 = rows[2].data();
    uint8_t* o = out + y * row;
    if (nc == 3 && rgb) {
      for (int x = 0; x < width; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    if (nc == 3) {
      for (int x = 0; x < width; ++x) {
        int Y = c0[x], b = c1[x], r = c2[x];
        o[3 * x] = clamp255(Y + t.cr_r[r]);
        o[3 * x + 1] = clamp255(Y + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16));
        o[3 * x + 2] = clamp255(Y + t.cb_b[b]);
      }
      continue;
    }
    const uint8_t* c3 = rows[3].data();
    for (int x = 0; x < width; ++x) {
      int cmy[3] = {c0[x], c1[x], c2[x]};
      if (ycck) {  // jdcolor.c, ycck_cmyk_convert
        int Y = c0[x], b = c1[x], r = c2[x];
        cmy[0] = clamp255(255 - (Y + t.cr_r[r]));
        cmy[1] = clamp255(255 - (Y + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16)));
        cmy[2] = clamp255(255 - (Y + t.cb_b[b]));
      }
      // PIL reads the samples as inverted CMYK ("CMYK;I"), so its cmyk2rgb
      // sees 255 - s for each, and its 255 - K is the stored K.
      int nk = c3[x];
      for (int k = 0; k < 3; ++k) o[3 * x + k] = clamp255(nk - muldiv255(255 - cmy[k], nk));
    }
  }
}

// -------------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Adam7's seven passes: first column and row, column and row step.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

void png_decode(const uint8_t* in, size_t n, int width, int height, int color_type, int depth,
                int interlace, const uint8_t* palette, int palette_entries, uint8_t* out) {
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: throw Error("bad PNG color type");
  }
  bool low = depth < 8;
  bool ok = depth == 8 || (depth == 16 && color_type != 3) ||
            (low && (color_type == 0 || color_type == 3) && (depth == 1 || depth == 2 || depth == 4));
  if (!ok) throw Error("PNG bit depth " + std::to_string(depth) + " is not supported");
  if (interlace > 1) throw Error("PNG interlace method " + std::to_string(interlace) + " is not supported");
  if (static_cast<long>(width) * height > kMaxPixels) throw Error("PNG too large");
  const size_t bpp = std::max<size_t>(1, static_cast<size_t>(channels) * depth / 8);
  const size_t bytes = depth == 16 ? 2 : 1;  // per sample
  const int scale = low && color_type == 0 ? 255 / ((1 << depth) - 1) : 1;
  const uint8_t* src = in;
  const uint8_t* end = in + n;
  for (int pass = 0; pass < (interlace ? 7 : 1); ++pass) {
    const int* a = interlace ? kAdam7[pass] : nullptr;
    const int x0 = a ? a[0] : 0, y0 = a ? a[1] : 0, dx = a ? a[2] : 1, dy = a ? a[3] : 1;
    const int pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
    const int ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows, not even filter bytes
    const size_t stride = (static_cast<size_t>(pw) * channels * depth + 7) / 8;
    if (static_cast<size_t>(end - src) < static_cast<size_t>(ph) * (stride + 1)) {
      throw Error("truncated PNG image data");
    }
    std::vector<uint8_t> prev(stride, 0), cur(stride);
    for (int r = 0; r < ph; ++r, src += stride + 1) {
      int filter = src[0];
      const uint8_t* s = src + 1;
      switch (filter) {
        case 0:
          std::memcpy(cur.data(), s, stride);
          break;
        case 1:
          for (size_t i = 0; i < stride; ++i)
            cur[i] = static_cast<uint8_t>(s[i] + (i >= bpp ? cur[i - bpp] : 0));
          break;
        case 2:
          for (size_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(s[i] + prev[i]);
          break;
        case 3:
          for (size_t i = 0; i < stride; ++i)
            cur[i] = static_cast<uint8_t>(s[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
          break;
        case 4:
          for (size_t i = 0; i < stride; ++i) {
            int pa = i >= bpp ? cur[i - bpp] : 0;
            int pc = i >= bpp ? prev[i - bpp] : 0;
            cur[i] = static_cast<uint8_t>(s[i] + paeth(pa, prev[i], pc));
          }
          break;
        default:
          throw Error("bad PNG filter type " + std::to_string(filter));
      }
      uint8_t* orow = out + static_cast<size_t>(y0 + r * dy) * width * 3;
      for (int x = 0; x < pw; ++x) {
        uint8_t* o = orow + static_cast<size_t>(x0 + x * dx) * 3;
        const uint8_t* p = &cur[static_cast<size_t>(x) * channels * bytes];
        if (low) {
          int per = 8 / depth;
          int shift = 8 - depth * (x % per + 1);
          int v = (cur[x / per] >> shift) & ((1 << depth) - 1);
          if (color_type == 3) {
            if (v < palette_entries) {
              o[0] = palette[3 * v];
              o[1] = palette[3 * v + 1];
              o[2] = palette[3 * v + 2];
            } else {
              o[0] = o[1] = o[2] = 0;
            }
          } else {
            o[0] = o[1] = o[2] = static_cast<uint8_t>(v * scale);
          }
        } else if (color_type == 3) {
          int v = p[0];
          if (v < palette_entries) {
            o[0] = palette[3 * v];
            o[1] = palette[3 * v + 1];
            o[2] = palette[3 * v + 2];
          } else {
            o[0] = o[1] = o[2] = 0;
          }
        } else if (color_type == 0 && depth == 16) {
          // PIL opens 16-bit grey as I;16, whose conversion clips at 255.
          int v = (p[0] << 8) | p[1];
          o[0] = o[1] = o[2] = static_cast<uint8_t>(v > 255 ? 255 : v);
        } else if (channels >= 3) {  // 16-bit: the high byte of each sample
          o[0] = p[0];
          o[1] = p[bytes];
          o[2] = p[2 * bytes];
        } else {
          o[0] = o[1] = o[2] = p[0];
        }
      }
      std::swap(prev, cur);
    }
  }
}

// ----------------------------------------------------------------- resize

// Bilinear taps along one axis, as F.interpolate (align_corners=False)
// places them: source index pairs and their f32 weights.
void bilinear_taps(int n_in, int n_out, std::vector<int>& i0, std::vector<int>& i1,
                   std::vector<float>& w0, std::vector<float>& w1) {
  const float scale = static_cast<float>(n_in) / static_cast<float>(n_out);
  i0.resize(n_out);
  i1.resize(n_out);
  w0.resize(n_out);
  w1.resize(n_out);
  for (int d = 0; d < n_out; ++d) {
    float src = (static_cast<float>(d) + 0.5f) * scale - 0.5f;
    if (src < 0.0f) src = 0.0f;
    int a = static_cast<int>(src);
    i0[d] = a;
    i1[d] = a < n_in - 1 ? a + 1 : a;
    w1[d] = src - static_cast<float>(a);
    w0[d] = 1.0f - w1[d];
  }
}

// Resize an (h, w, 3) uint8 image to (nh, nw, 3): each source row
// interpolated across, then the rows down, each product and sum rounded to
// f32 (native/build.py compiles with -ffp-contract=off: no fused
// multiply-add), rounded half to even and clamped.  One thread, so the
// pixels never depend on how work is split.
void resize_bilinear(const uint8_t* in, int h, int w, uint8_t* out, int nh, int nw) {
  if (h < 1 || w < 1 || nh < 1 || nw < 1) throw Error("bad resize shape");
  if (static_cast<long>(nh) * nw > kMaxPixels) throw Error("resize output too large");
  std::vector<int> x0, x1, y0, y1;
  std::vector<float> wx0, wx1, wy0, wy1;
  bilinear_taps(w, nw, x0, x1, wx0, wx1);
  bilinear_taps(h, nh, y0, y1, wy0, wy1);
  const size_t row = static_cast<size_t>(nw) * 3;
  // Two source rows interpolated across, cached by source row index.
  std::vector<float> across[2] = {std::vector<float>(row), std::vector<float>(row)};
  int held[2] = {-1, -1};
  auto across_row = [&](int r) -> const float* {
    for (int k = 0; k < 2; ++k) {
      if (held[k] == r) return across[k].data();
    }
    int k = held[0] < held[1] ? 0 : 1;  // rows are asked for in order: evict the lower
    const uint8_t* src = in + static_cast<size_t>(r) * w * 3;
    float* dst = across[k].data();
    for (int x = 0; x < nw; ++x) {
      const uint8_t* a = src + 3 * x0[x];
      const uint8_t* b = src + 3 * x1[x];
      for (int c = 0; c < 3; ++c) {
        dst[3 * x + c] = static_cast<float>(a[c]) * wx0[x] + static_cast<float>(b[c]) * wx1[x];
      }
    }
    held[k] = r;
    return dst;
  };
  for (int y = 0; y < nh; ++y) {
    const float* top = across_row(y0[y]);
    const float* bot = across_row(y1[y]);
    uint8_t* o = out + static_cast<size_t>(y) * row;
    const float a = wy0[y], b = wy1[y];
    for (size_t i = 0; i < row; ++i) {
      float v = std::nearbyint(top[i] * a + bot[i] * b);
      o[i] = static_cast<uint8_t>(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
    }
  }
}

// ------------------------------------------------------------- GIF, TIFF

// A GIF image's LZW data (its sub-blocks joined) as the palette indices of
// a width x height frame, rows in display order, as Pillow's GifDecode.c
// expands it: least significant bit first, codes from min_code_size + 1 bits
// wide up to 12, the code width growing once the table's entry (1 << width) -
// 1 is made, a full table kept until the next clear code (no entries are
// added meanwhile), and interlaced rows in the four passes (every 8th row
// from 0, from 4, every 4th from 2, every 2nd from 1).  Pixels the data
// does not reach keep what ``out`` held.  Data after the frame's last pixel
// or after the end code is ignored.
void gif_lzw(const uint8_t* in, size_t n, int min_code_size, int width, int height, bool interlace,
             uint8_t* out) {
  if (min_code_size < 1 || min_code_size > 11) throw Error("bad GIF LZW code size");
  if (width <= 0 || height <= 0) return;
  const int clear = 1 << min_code_size, end = clear + 1;
  int size = min_code_size + 1, mask = (1 << size) - 1, next = clear + 2;
  int last = -1, first = 0;
  std::vector<uint16_t> link(4096);
  std::vector<uint8_t> suffix(4096), stack(4097);
  for (int i = 0; i < clear; ++i) suffix[i] = static_cast<uint8_t>(i);
  uint32_t bits = 0;
  int count = 0;
  size_t pos = 0;
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  auto put = [&](uint8_t v) -> bool {  // false once the frame is full
    out[static_cast<size_t>(y) * width + x] = v;
    if (++x < width) return true;
    x = 0;
    y += step;
    while (y >= height) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 4; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    while (count < size) {
      if (pos >= n) return;
      bits |= static_cast<uint32_t>(in[pos++]) << count;
      count += 8;
    }
    const int code = static_cast<int>(bits & mask);
    bits >>= size;
    count -= size;
    if (code == clear) {
      size = min_code_size + 1;
      mask = (1 << size) - 1;
      next = clear + 2;
      last = -1;
      continue;
    }
    if (code == end) return;
    if (last < 0) {
      if (code > clear) throw Error("corrupt GIF image data");
      first = code;
      last = code;
      if (!put(static_cast<uint8_t>(code))) return;
      continue;
    }
    int sp = 0, c = code;
    if (code >= next) {
      if (code > next) throw Error("corrupt GIF image data");
      stack[sp++] = static_cast<uint8_t>(first);
      c = last;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = link[c];
    }
    stack[sp++] = static_cast<uint8_t>(c);
    first = c;
    while (sp > 0) {
      if (!put(stack[--sp])) return;
    }
    if (next < 4096) {
      link[next] = static_cast<uint16_t>(last);
      suffix[next] = static_cast<uint8_t>(first);
      if (next == mask && size < 12) {
        ++size;
        mask = (1 << size) - 1;
      }
      ++next;
    }
    last = code;
  }
}

// TIFF LZW (compression 5) as libtiff's LZWDecode reads it: most
// significant bit first, 256 clears and 257 ends, codes 9 bits wide growing
// one code early (to 10 once the next free entry is 511, 11 at 1023, 12 at
// 2047).  Writes at most ``cap`` bytes; returns how many it wrote.
size_t tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  const int kClear = 256, kEnd = 257, kSize = 4096 + 1024;
  std::vector<int32_t> prefix(kSize, -1);
  std::vector<uint8_t> suffix(kSize), first(kSize);
  std::vector<uint32_t> length(kSize, 1);
  for (int i = 0; i < 256; ++i) suffix[i] = first[i] = static_cast<uint8_t>(i);
  int width = 9, next = 258, old = -1;
  uint64_t bits = 0;
  int count = 0;
  size_t pos = 0, w = 0;
  auto emit = [&](int code) {
    const uint32_t len = length[code];
    size_t at = w + len;
    for (int c = code; c >= 0; c = prefix[c]) {
      --at;
      if (at < cap) out[at] = suffix[c];
    }
    w += len;
  };
  for (;;) {
    while (count < width) {
      if (pos >= n) return std::min(w, cap);
      bits = (bits << 8) | in[pos++];
      count += 8;
    }
    const int code = static_cast<int>((bits >> (count - width)) & ((1u << width) - 1));
    count -= width;
    if (code == kEnd) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) throw Error("corrupt TIFF LZW data");
      emit(code);
      old = code;
    } else {
      if (code > next || next >= kSize) throw Error("corrupt TIFF LZW data");
      prefix[next] = old;
      first[next] = first[old];
      suffix[next] = code < next ? first[code] : first[old];
      length[next] = length[old] + 1;
      emit(code);
      ++next;
      if (next > (1 << width) - 2 && width < 12) ++width;
      old = code;
    }
    if (w >= cap) break;
  }
  return std::min(w, cap);
}

// PackBits (compression 32773): a header byte n copies n + 1 literal bytes
// (0 <= n <= 127), repeats the next byte 1 - n times (-127 <= n <= -1), or
// is skipped (-128).  Writes at most ``cap`` bytes; returns how many.
size_t packbits(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  size_t pos = 0, w = 0;
  while (pos < n && w < cap) {
    const int h = static_cast<int8_t>(in[pos++]);
    if (h >= 0) {
      for (int i = 0; i <= h && pos < n; ++i, ++pos) {
        if (w < cap) out[w++] = in[pos];
      }
    } else if (h != -128) {
      if (pos >= n) break;
      const uint8_t v = in[pos++];
      for (int i = 0; i < 1 - h && w < cap; ++i) out[w++] = v;
    }
  }
  return w;
}

// ------------------------------------------------------------- WebP VP8

// A lossy WebP's VP8 key frame (RFC 6386), decoded as libwebp 1.6 decodes
// it: the boolean decoder, the frame and segment headers, the token
// partitions, intra prediction from the unfiltered neighbours (127 above
// the frame, 129 left of it), dequantization, the inverse WHT and DCT, the
// normal or simple loop filter over the whole frame in macroblock order,
// then libwebp's "fancy" chroma upsampling and its 14-bit fixed-point
// YUV -> RGB (yuv.h), which is what WebPDecode gives PIL.  The 4x4 modes
// are numbered as libwebp numbers them (DC TM VE HE RD VR LD VL HD HU), and
// the default probabilities below are RFC 6386's in that order.

const uint8_t kVp8CoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kVp8CoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kVp8BModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kVp8DcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kVp8AcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kVp8lCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

enum { kDC = 0, kTM, kVE, kHE, kRD, kVR, kLD, kVL, kHD, kHU };
const uint8_t kVp8Zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kVp8Bands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kVp8Cat3[] = {173, 148, 140, 0};
const uint8_t kVp8Cat4[] = {176, 155, 140, 135, 0};
const uint8_t kVp8Cat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kVp8Cat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kVp8Cat3456[] = {kVp8Cat3, kVp8Cat4, kVp8Cat5, kVp8Cat6};
// The offset of each 4x4 luma block in the 32-byte-stride work buffer.
constexpr int kBps = 32;
const int kVp8Scan[16] = {0 + 0 * kBps,  4 + 0 * kBps,  8 + 0 * kBps,  12 + 0 * kBps,
                          0 + 4 * kBps,  4 + 4 * kBps,  8 + 4 * kBps,  12 + 4 * kBps,
                          0 + 8 * kBps,  4 + 8 * kBps,  8 + 8 * kBps,  12 + 8 * kBps,
                          0 + 12 * kBps, 4 + 12 * kBps, 8 + 12 * kBps, 12 + 12 * kBps};

// RFC 6386's boolean decoder; bytes past the end read as zeros.
class BoolReader {
 public:
  BoolReader() = default;
  BoolReader(const uint8_t* p, size_t n) : p_(p), end_(p + n) { value_ = (next() << 8) | next(); }
  int bit(int prob) {
    const uint32_t split = 1 + (((range_ - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big = split << 8;
    int b;
    if (value_ >= big) {
      b = 1;
      range_ -= split;
      value_ -= big;
    } else {
      b = 0;
      range_ = split;
    }
    while (range_ < 128) {
      value_ <<= 1;
      range_ <<= 1;
      if (++count_ == 8) {
        count_ = 0;
        value_ |= next();
      }
    }
    return b;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int flag() { return bit(128); }
  int signed_literal(int n) {
    const int v = literal(n);
    return flag() ? -v : v;
  }

 private:
  uint32_t next() { return p_ < end_ ? *p_++ : 0; }
  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint32_t value_ = 0, range_ = 255;
  int count_ = 0;
};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// Inverse DCT of one 4x4 block, added to the prediction (dsp/dec.c TransformOne).
void vp8_idct_add(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * kBps;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// Inverse Walsh-Hadamard transform of the Y2 block into the DC of the 16
// luma blocks (dsp/dec.c TransformWHT).
void vp8_iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction into the work buffer (dsp/dec.c)
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[y * kBps - 1];
    for (int x = 0; x < size; ++x) dst[y * kBps + x] = clip8(top[x] + l - tl);
  }
}

void fill_block(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, v, size);
}

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction; DC is chosen by
// which neighbours exist.
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case kDC: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - kBps] + dst[-1 + i * kBps];
        dc = (dc + size) >> (shift + 1);
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - kBps];
        dc = (dc + (size >> 1)) >> shift;
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * kBps];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill_block(dst, size, dc);
      break;
    }
    case kTM: true_motion(dst, size); break;
    case kVE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * kBps, dst - kBps, size);
      break;
    case kHE:
      for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, dst[y * kBps - 1], size);
      break;
    default: throw Error("bad VP8 prediction mode");
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7], X = top[-1];
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
  switch (mode) {
    case kDC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * kBps];
      fill_block(dst, 4, dc >> 3);
      break;
    }
    case kTM: true_motion(dst, 4); break;
    case kVE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * kBps, v, 4);
      break;
    }
    case kHE: {
      std::memset(dst + 0 * kBps, avg3(X, I, J), 4);
      std::memset(dst + 1 * kBps, avg3(I, J, K), 4);
      std::memset(dst + 2 * kBps, avg3(J, K, L), 4);
      std::memset(dst + 3 * kBps, avg3(K, L, L), 4);
      break;
    }
    case kRD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case kLD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case kVR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case kVL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case kHD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case kHU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    default: throw Error("bad VP8 4x4 prediction mode");
  }
}
#undef DST

// ---- loop filter (dsp/dec.c), on a plane with the given stride
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// ``hstride`` steps across the edge, ``vstride`` along it.
void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
  }
}

void edge_filter(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool macroblock_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (macroblock_edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

struct Vp8FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Vp8Mb {
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t modes[16] = {0};
};

void vp8_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height) {
  if (size < 10) throw Error("truncated VP8 frame header");
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  if (tag & 1) throw Error("VP8 frame is not a key frame");
  if (((tag >> 1) & 7) > 3) throw Error("bad VP8 profile");
  if (!((tag >> 4) & 1)) throw Error("VP8 frame is not displayable");
  const size_t part0 = tag >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) throw Error("bad VP8 start code");
  const int w = (data[6] | (data[7] << 8)) & 0x3fff;
  const int h = (data[8] | (data[9] << 8)) & 0x3fff;
  if (w != width || h != height) throw Error("VP8 frame size differs from the header's");
  if (w == 0 || h == 0) throw Error("empty VP8 frame");
  if (part0 > size - 10) throw Error("truncated VP8 first partition");
  BoolReader br(data + 10, part0);
  const uint8_t* parts_start = data + 10 + part0;
  size_t parts_size = size - 10 - part0;

  br.flag();  // colour space
  br.flag();  // clamping type
  // Segment header (vp8_dec.c ParseSegmentHeader).
  bool use_segment = br.flag(), update_map = false, absolute_delta = true;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  int seg_prob[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.flag();
    if (br.flag()) {
      absolute_delta = br.flag();
      for (int& q : seg_quant) q = br.flag() ? br.signed_literal(7) : 0;
      for (int& f : seg_filter) f = br.flag() ? br.signed_literal(6) : 0;
    }
    if (update_map) {
      for (int& p : seg_prob) p = br.flag() ? br.literal(8) : 255;
    }
  }
  // Filter header.
  const int simple = br.flag(), level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.flag();
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.flag()) {
    for (int& d : ref_lf_delta) {
      if (br.flag()) d = br.signed_literal(6);
    }
    for (int& d : mode_lf_delta) {
      if (br.flag()) d = br.signed_literal(6);
    }
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // Token partitions.
  const int num_parts = 1 << br.literal(2);
  if (parts_size < 3 * static_cast<size_t>(num_parts - 1)) throw Error("truncated VP8 partitions");
  std::vector<BoolReader> parts(num_parts);
  {
    const uint8_t* sz = parts_start;
    const uint8_t* part = parts_start + 3 * (num_parts - 1);
    size_t left = parts_size - 3 * (num_parts - 1);
    for (int p = 0; p < num_parts - 1; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p] = BoolReader(part, psize);
      part += psize;
      left -= psize;
    }
    parts[num_parts - 1] = BoolReader(part, left);
  }
  // Quantizers (quant_dec.c VP8ParseQuant).
  const int base_q0 = br.literal(7);
  int dq[5];
  for (int& d : dq) d = br.flag() ? br.signed_literal(4) : 0;
  const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2], dquv_dc = dq[3], dquv_ac = dq[4];
  int y1m[4][2], y2m[4][2], uvm[4][2];
  auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q = base_q0;
    if (use_segment) {
      q = seg_quant[s] + (absolute_delta ? 0 : base_q0);
    } else if (s > 0) {
      std::memcpy(y1m[s], y1m[0], sizeof(y1m[0]));
      std::memcpy(y2m[s], y2m[0], sizeof(y2m[0]));
      std::memcpy(uvm[s], uvm[0], sizeof(uvm[0]));
      continue;
    }
    y1m[s][0] = kVp8DcTable[clipq(q + dqy1_dc, 127)];
    y1m[s][1] = kVp8AcTable[clipq(q, 127)];
    y2m[s][0] = kVp8DcTable[clipq(q + dqy2_dc, 127)] * 2;
    y2m[s][1] = (kVp8AcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;
    if (y2m[s][1] < 8) y2m[s][1] = 8;
    uvm[s][0] = kVp8DcTable[clipq(q + dquv_dc, 117)];
    uvm[s][1] = kVp8AcTable[clipq(q + dquv_ac, 127)];
  }
  br.flag();  // refresh entropy probabilities: ignored for a key frame
  // Token probabilities (tree_dec.c VP8ParseProba).
  uint8_t proba[4][8][3][11];
  for (int t = 0, i = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p, ++i) {
          proba[t][b][c][p] = static_cast<uint8_t>(
              br.bit(kVp8CoeffsUpdateProba[i]) ? br.literal(8) : kVp8CoeffsProba0[i]);
        }
      }
    }
  }
  const bool use_skip = br.flag();
  const int skip_p = use_skip ? br.literal(8) : 0;

  const int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  // Every macroblock's modes, from the first partition (ParseIntraMode).
  std::vector<Vp8Mb> mbs(static_cast<size_t>(mb_w) * mb_h);
  {
    std::vector<uint8_t> intra_t(4 * static_cast<size_t>(mb_w), kDC);
    for (int my = 0; my < mb_h; ++my) {
      uint8_t intra_l[4] = {kDC, kDC, kDC, kDC};
      for (int mx = 0; mx < mb_w; ++mx) {
        Vp8Mb& mb = mbs[static_cast<size_t>(my) * mb_w + mx];
        uint8_t* top = &intra_t[4 * mx];
        if (update_map) {
          mb.segment = !br.bit(seg_prob[0]) ? br.bit(seg_prob[1]) : br.bit(seg_prob[2]) + 2;
        }
        if (use_skip) mb.skip = br.bit(skip_p);
        mb.is_i4x4 = !br.bit(145);
        if (!mb.is_i4x4) {
          const int ymode = br.bit(156) ? (br.bit(128) ? kTM : kHE) : (br.bit(163) ? kVE : kDC);
          mb.modes[0] = ymode;
          std::memset(top, ymode, 4);
          std::memset(intra_l, ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = &kVp8BModesProba[(top[x] * 10 + ymode) * 9];
              ymode = !br.bit(prob[0])   ? kDC
                      : !br.bit(prob[1]) ? kTM
                      : !br.bit(prob[2]) ? kVE
                      : !br.bit(prob[3])
                          ? (!br.bit(prob[4]) ? kHE : (!br.bit(prob[5]) ? kRD : kVR))
                          : (!br.bit(prob[6])
                                 ? kLD
                                 : (!br.bit(prob[7]) ? kVL : (!br.bit(prob[8]) ? kHD : kHU)));
              top[x] = static_cast<uint8_t>(ymode);
            }
            std::memcpy(mb.modes + 4 * y, top, 4);
            intra_l[y] = static_cast<uint8_t>(ymode);
          }
        }
        mb.uvmode = !br.bit(142) ? kDC : !br.bit(114) ? kVE : br.bit(183) ? kTM : kHE;
      }
    }
  }

  // Filter strengths by segment and by 4x4-ness (PrecomputeFilterStrengths).
  Vp8FilterInfo fstrengths[4][2];
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level = level;
      if (use_segment) base_level = seg_filter[s] + (absolute_delta ? 0 : level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        Vp8FilterInfo& info = fstrengths[s][i4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lv + ilevel;
          info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4 != 0;
      }
    }
  }

  // Reconstruction into unfiltered planes, one macroblock at a time.
  const int ys = mb_w * 16, uvs = mb_w * 8;
  std::vector<uint8_t> Y(static_cast<size_t>(ys) * mb_h * 16), U(static_cast<size_t>(uvs) * mb_h * 8),
      V(static_cast<size_t>(uvs) * mb_h * 8);
  std::vector<Vp8FilterInfo> finfo(mbs.size());
  // Non-zero flags of the blocks above (per macroblock column: 4 Y, 2 U,
  // 2 V, 1 Y2) and to the left.
  std::vector<uint8_t> nz_top(9 * static_cast<size_t>(mb_w), 0);
  uint8_t ws[kBps * 17 + kBps * 9];
  uint8_t* const ydst = ws + kBps * 1 + 8;
  uint8_t* const udst = ydst + kBps * 16 + kBps;
  uint8_t* const vdst = udst + 16;
  int16_t coeffs[384];

  // GetCoeffs: the tokens of one block from coefficient ``n`` on, dequantized
  // into ``out`` in natural order; returns the position after the last token.
  auto get_coeffs = [&](BoolReader& tb, int type, int ctx, const int* dqm, int n, int16_t* out) {
    const uint8_t* p = proba[type][kVp8Bands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.bit(p[0])) return n;
      while (!tb.bit(p[1])) {
        p = proba[type][kVp8Bands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int band_next = kVp8Bands[n + 1];
      if (!tb.bit(p[2])) {
        v = 1;
        p = proba[type][band_next][1];
      } else {
        if (!tb.bit(p[3])) {
          v = !tb.bit(p[4]) ? 2 : 3 + tb.bit(p[5]);
        } else if (!tb.bit(p[6])) {
          if (!tb.bit(p[7])) {
            v = 5 + tb.bit(159);
          } else {
            v = 7 + 2 * tb.bit(165);
            v += tb.bit(145);
          }
        } else {
          const int bit1 = tb.bit(p[8]);
          const int bit0 = tb.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kVp8Cat3456[cat]; *tab; ++tab) v += v + tb.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba[type][band_next][2];
      }
      out[kVp8Zigzag[n]] = static_cast<int16_t>((tb.flag() ? -v : v) * dqm[n > 0]);
    }
    return 16;
  };

  for (int my = 0; my < mb_h; ++my) {
    BoolReader& tb = parts[my & (num_parts - 1)];
    uint8_t nz_left[9] = {0};
    for (int mx = 0; mx < mb_w; ++mx) {
      const size_t mi = static_cast<size_t>(my) * mb_w + mx;
      const Vp8Mb& mb = mbs[mi];
      uint8_t* nzt = &nz_top[9 * mx];
      std::memset(coeffs, 0, sizeof(coeffs));
      bool skip = use_skip && mb.skip;
      if (!skip) {  // ParseResiduals
        const int seg = mb.segment;
        bool non_zero = false;
        int first, ytype;
        if (!mb.is_i4x4) {
          int16_t dc[16] = {0};
          const int nz = get_coeffs(tb, 1, nzt[8] + nz_left[8], y2m[seg], 0, dc);
          nzt[8] = nz_left[8] = nz > 0;
          if (nz > 1) {
            vp8_iwht(dc, coeffs);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) coeffs[i] = static_cast<int16_t>(dc0);
          }
          first = 1;
          ytype = 0;
        } else {
          first = 0;
          ytype = 3;
        }
        for (int y = 0; y < 4; ++y) {
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = coeffs + 16 * (4 * y + x);
            const int nz = get_coeffs(tb, ytype, nzt[x] + nz_left[y], y1m[seg], first, blk);
            nzt[x] = nz_left[y] = nz > first;
            non_zero |= nz > 1 || blk[0] != 0;
          }
        }
        for (int ch = 0; ch < 2; ++ch) {  // U, then V
          for (int y = 0; y < 2; ++y) {
            for (int x = 0; x < 2; ++x) {
              int16_t* blk = coeffs + 256 + 64 * ch + 16 * (2 * y + x);
              uint8_t& t = nzt[4 + 2 * ch + x];
              uint8_t& l = nz_left[4 + 2 * ch + y];
              const int nz = get_coeffs(tb, 2, t + l, uvm[seg], 0, blk);
              t = l = nz > 0;
              non_zero |= nz > 1 || blk[0] != 0;
            }
          }
        }
        skip = !non_zero;
      } else {
        std::memset(nzt, 0, 8);
        std::memset(nz_left, 0, 8);
        if (!mb.is_i4x4) nzt[8] = nz_left[8] = 0;
      }
      if (filter_type > 0) {
        finfo[mi] = fstrengths[mb.segment][mb.is_i4x4];
        finfo[mi].inner = finfo[mi].inner || !skip;
      }

      // The work buffer's borders (frame_dec.c ReconstructRow).
      const int x0 = mx * 16, y0 = my * 16, cx0 = mx * 8, cy0 = my * 8;
      for (int j = 0; j < 16; ++j) ydst[j * kBps - 1] = mx > 0 ? Y[(y0 + j) * ys + x0 - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        udst[j * kBps - 1] = mx > 0 ? U[(cy0 + j) * uvs + cx0 - 1] : 129;
        vdst[j * kBps - 1] = mx > 0 ? V[(cy0 + j) * uvs + cx0 - 1] : 129;
      }
      if (my == 0) {
        std::memset(ydst - kBps - 1, 127, 16 + 4 + 1);
        std::memset(udst - kBps - 1, 127, 8 + 1);
        std::memset(vdst - kBps - 1, 127, 8 + 1);
      } else {
        ydst[-kBps - 1] = mx > 0 ? Y[(y0 - 1) * ys + x0 - 1] : 129;
        udst[-kBps - 1] = mx > 0 ? U[(cy0 - 1) * uvs + cx0 - 1] : 129;
        vdst[-kBps - 1] = mx > 0 ? V[(cy0 - 1) * uvs + cx0 - 1] : 129;
        std::memcpy(ydst - kBps, &Y[(y0 - 1) * ys + x0], 16);
        std::memcpy(udst - kBps, &U[(cy0 - 1) * uvs + cx0], 8);
        std::memcpy(vdst - kBps, &V[(cy0 - 1) * uvs + cx0], 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = ydst - kBps + 16;
        if (my > 0) {
          if (mx >= mb_w - 1) {
            std::memset(top_right, Y[(y0 - 1) * ys + x0 + 15], 4);
          } else {
            std::memcpy(top_right, &Y[(y0 - 1) * ys + x0 + 16], 4);
          }
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * kBps, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + kVp8Scan[n];
          predict4(dst, mb.modes[n]);
          vp8_idct_add(coeffs + 16 * n, dst);
        }
      } else {
        predict_block(ydst, 16, mb.modes[0], my > 0, mx > 0);
        for (int n = 0; n < 16; ++n) vp8_idct_add(coeffs + 16 * n, ydst + kVp8Scan[n]);
      }
      predict_block(udst, 8, mb.uvmode, my > 0, mx > 0);
      predict_block(vdst, 8, mb.uvmode, my > 0, mx > 0);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
        vp8_idct_add(coeffs + 256 + 16 * n, udst + off);
        vp8_idct_add(coeffs + 320 + 16 * n, vdst + off);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(&Y[(y0 + j) * ys + x0], ydst + j * kBps, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(cy0 + j) * uvs + cx0], udst + j * kBps, 8);
        std::memcpy(&V[(cy0 + j) * uvs + cx0], vdst + j * kBps, 8);
      }
    }
  }

  // The loop filter, macroblock by macroblock in raster order (DoFilter).
  if (filter_type > 0) {
    for (int my = 0; my < mb_h; ++my) {
      for (int mx = 0; mx < mb_w; ++mx) {
        const Vp8FilterInfo& f = finfo[static_cast<size_t>(my) * mb_w + mx];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = &Y[my * 16 * ys + mx * 16];
        if (filter_type == 1) {
          if (mx > 0) simple_filter(y, 1, ys, 16, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, 16, limit);
          }
          if (my > 0) simple_filter(y, ys, 1, 16, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_filter(y + k * ys, ys, 1, 16, limit);
          }
          continue;
        }
        uint8_t* u = &U[my * 8 * uvs + mx * 8];
        uint8_t* v = &V[my * 8 * uvs + mx * 8];
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mx > 0) {
          edge_filter(y, 1, ys, 16, limit + 4, il, ht, true);
          edge_filter(u, 1, uvs, 8, limit + 4, il, ht, true);
          edge_filter(v, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) edge_filter(y + k, 1, ys, 16, limit, il, ht, false);
          edge_filter(u + 4, 1, uvs, 8, limit, il, ht, false);
          edge_filter(v + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (my > 0) {
          edge_filter(y, ys, 1, 16, limit + 4, il, ht, true);
          edge_filter(u, uvs, 1, 8, limit + 4, il, ht, true);
          edge_filter(v, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) edge_filter(y + k * ys, ys, 1, 16, limit, il, ht, false);
          edge_filter(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          edge_filter(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
      }
    }
  }

  // Fancy upsampling and YUV -> RGB (upsampling.c, yuv.h): each output row
  // takes its nearest chroma row (weight 3) and the next one away from it
  // (weight 1), the first and last rows their own twice.
  const int uv_h = (h + 1) / 2;
  auto mult_hi = [](int v, int c) { return (v * c) >> 8; };
  auto clip_yuv = [](int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; };
  auto put = [&](uint8_t* o, int yv, int uv) {
    const int u = uv & 0xff, vv = uv >> 8;
    o[0] = static_cast<uint8_t>(clip_yuv(mult_hi(yv, 19077) + mult_hi(vv, 26149) - 14234));
    o[1] = static_cast<uint8_t>(
        clip_yuv(mult_hi(yv, 19077) - mult_hi(u, 6419) - mult_hi(vv, 13320) + 8708));
    o[2] = static_cast<uint8_t>(clip_yuv(mult_hi(yv, 19077) + mult_hi(u, 33050) - 17685));
  };
  const int last_pair = (w - 1) >> 1;
  for (int r = 0; r < h; ++r) {
    const int near = r >> 1;
    int far = (r & 1) ? near + 1 : near - 1;
    if (far < 0) far = 0;
    if (far > uv_h - 1) far = uv_h - 1;
    if (r == 0) far = 0;
    const uint8_t* yrow = &Y[static_cast<size_t>(r) * ys];
    const uint8_t *nu = &U[near * uvs], *nv = &V[near * uvs], *fu = &U[far * uvs], *fv = &V[far * uvs];
    uint8_t* o = out + static_cast<size_t>(r) * w * 3;
    // Per chroma channel: value at pixel x of the row.
    auto chan = [&](const uint8_t* n, const uint8_t* f, int x) {
      if (x == 0) return (3 * n[0] + f[0] + 2) >> 2;
      const int k = (x + 1) >> 1;  // pixel 2k - 1 or 2k
      if (k > last_pair) return (3 * n[last_pair] + f[last_pair] + 2) >> 2;  // last of an even row
      const int tl = n[k - 1], t = n[k], l = f[k - 1], cur = f[k];
      if (x & 1) {
        const int diag = (tl + 3 * t + 3 * l + cur + 8) >> 3;
        return (diag + tl) >> 1;
      }
      const int diag = (3 * tl + t + l + 3 * cur + 8) >> 3;
      return (diag + t) >> 1;
    };
    for (int x = 0; x < w; ++x) {
      const int u = chan(nu, fu, x), v = chan(nv, fv, x);
      put(o + 3 * x, yrow[x], u | (v << 8));
    }
  }
}

// ------------------------------------------------------------ WebP VP8L

// A lossless WebP's VP8L bitstream (RFC 9649) as libwebp decodes it: the
// transforms (predictor, cross colour, subtract green, colour indexing),
// canonical prefix codes (simple or coded lengths; a code of one symbol
// reads no bits), meta prefix codes by entropy-image tile, LZ77 copies with
// the 120 two-dimensional distance codes, and the colour cache.  The result
// is ARGB; convert("RGB") keeps R, G and B.

class Vp8lBits {
 public:
  Vp8lBits(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  uint32_t read(int nbits) {
    if (nbits == 0) return 0;
    fill();
    const uint32_t v = static_cast<uint32_t>(buf_ & ((uint64_t{1} << nbits) - 1));
    buf_ >>= nbits;
    count_ -= nbits;
    return v;
  }
  uint32_t peek(int nbits) {
    fill();
    return static_cast<uint32_t>(buf_ & ((uint64_t{1} << nbits) - 1));
  }
  void skip(int nbits) {
    buf_ >>= nbits;
    count_ -= nbits;
  }
  bool overran() const { return pos_ > n_ + 8; }

 private:
  void fill() {
    while (count_ <= 56) {
      buf_ |= static_cast<uint64_t>(pos_ < n_ ? p_[pos_] : 0) << count_;
      ++pos_;
      count_ += 8;
    }
  }
  const uint8_t* p_;
  size_t n_, pos_ = 0;
  uint64_t buf_ = 0;
  int count_ = 0;
};

// A canonical prefix code: an 8-bit first-level table, then bit by bit.
class PrefixCode {
 public:
  void build(const std::vector<int>& lengths) {
    counts_.assign(16, 0);
    int used = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 15) throw Error("bad VP8L code length");
      if (lengths[s] > 0) {
        ++counts_[lengths[s]];
        ++used;
        last = static_cast<int>(s);
      }
    }
    if (used == 0) throw Error("empty VP8L prefix code");
    single_ = used == 1 ? last : -1;
    if (single_ >= 0) return;
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = 2 * left - counts_[len];
      if (left < 0) throw Error("over-subscribed VP8L prefix code");
    }
    if (left != 0) throw Error("incomplete VP8L prefix code");
    std::vector<int> offs(16, 0);
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + counts_[len];
    sorted_.assign(used, 0);
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 0) sorted_[offs[lengths[s]]++] = static_cast<int>(s);
    }
    table_.assign(1 << kRoot, 0);
    int code = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int i = 0; i < counts_[len]; ++i, ++code, ++index) {
        if (len > kRoot) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < (1 << kRoot); fill += 1 << len) {
          table_[fill] = (static_cast<uint32_t>(len) << 16) | static_cast<uint32_t>(sorted_[index]);
        }
      }
      code <<= 1;
    }
  }
  int read(Vp8lBits& br) const {
    if (single_ >= 0) return single_;
    const uint32_t e = table_[br.peek(kRoot)];
    if (e >> 16) {
      br.skip(static_cast<int>(e >> 16));
      return static_cast<int>(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= static_cast<int>(br.read(1));
      const int count = counts_[len];
      if (code - first < count) return sorted_[index + code - first];
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    throw Error("corrupt VP8L prefix code");
  }

 private:
  static constexpr int kRoot = 8;
  std::vector<int> counts_, sorted_;
  std::vector<uint32_t> table_;
  int single_ = -1;
};

struct Vp8lTransform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

class Vp8l {
 public:
  Vp8l(const uint8_t* p, size_t n) : br_(p, n) {}

  std::vector<uint32_t> decode(int width, int height) {
    if (br_.read(8) != 0x2f) throw Error("bad VP8L signature");
    const int w = static_cast<int>(br_.read(14)) + 1, h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha is used
    if (br_.read(3) != 0) throw Error("bad VP8L version");
    if (w != width || h != height) throw Error("VP8L size differs from the header's");
    return image_stream(w, h, true);
  }

 private:
  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0) {
    std::vector<Vp8lTransform> transforms;
    int tx = xsize;
    if (level0) {
      int seen = 0;
      while (br_.read(1)) {
        Vp8lTransform t{static_cast<int>(br_.read(2)), 0, tx, {}};
        if (seen & (1 << t.type)) throw Error("repeated VP8L transform");
        seen |= 1 << t.type;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(br_.read(3)) + 2;
          t.data = image_stream(subsample(tx, t.bits), subsample(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int colors = static_cast<int>(br_.read(8)) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image_stream(colors, 1, false);
          for (int i = 1; i < colors; ++i) pal[i] = add_pixels(pal[i], pal[i - 1]);
          pal.resize(static_cast<size_t>(1) << (8 >> t.bits), 0);
          t.data = std::move(pal);
          tx = subsample(tx, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) throw Error("bad VP8L colour cache size");
    }
    // Meta prefix codes.
    int meta_bits = 0, meta_w = 0, groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_w = subsample(tx, meta_bits);
      meta = image_stream(meta_w, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, static_cast<int>(m) + 1);
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int sizes[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    std::vector<PrefixCode> codes(5 * static_cast<size_t>(groups));
    for (int g = 0; g < groups; ++g) {
      for (int k = 0; k < 5; ++k) read_code(sizes[k], codes[5 * g + k]);
    }
    // The pixels.
    const size_t total = static_cast<size_t>(tx) * ysize;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_size, 0);
    size_t src = 0, cached = 0;
    int col = 0, row = 0;
    auto insert_cached = [&]() {
      if (!cache_size) {
        cached = src;
        return;
      }
      for (; cached < src; ++cached) {
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
      }
    };
    while (src < total) {
      const int g = meta_bits ? static_cast<int>(meta[(row >> meta_bits) * meta_w + (col >> meta_bits)]) : 0;
      const PrefixCode* c = &codes[5 * g];
      const int code = c[0].read(br_);
      if (code < 256) {
        const uint32_t r = c[1].read(br_), b = c[2].read(br_), a = c[3].read(br_);
        px[src++] = (a << 24) | (r << 16) | (static_cast<uint32_t>(code) << 8) | b;
        if (++col >= tx) {
          col = 0;
          ++row;
        }
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dsym = c[4].read(br_);
        const int dcode = copy_value(dsym);
        const size_t dist = plane_distance(tx, dcode);
        if (dist > src || static_cast<size_t>(length) > total - src) throw Error("corrupt VP8L backward reference");
        for (int i = 0; i < length; ++i, ++src) px[src] = px[src - dist];
        col += length;
        while (col >= tx) {
          col -= tx;
          ++row;
        }
      } else {
        if (!cache_size) throw Error("corrupt VP8L colour cache code");
        insert_cached();
        px[src++] = cache[code - 280];
        if (++col >= tx) {
          col = 0;
          ++row;
        }
      }
      if (br_.overran()) throw Error("truncated VP8L data");
      insert_cached();
    }
    // The inverse transforms, last read first.
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) px = inverse(*t, px, ysize);
    return px;
  }

  void read_code(int alphabet, PrefixCode& code) {
    std::vector<int> lengths(alphabet, 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      const int num = static_cast<int>(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      const int s0 = static_cast<int>(br_.read(first_bits));
      if (s0 >= alphabet) throw Error("bad VP8L simple code");
      lengths[s0] = 1;
      if (num == 2) {
        const int s1 = static_cast<int>(br_.read(8));
        if (s1 >= alphabet) throw Error("bad VP8L simple code");
        lengths[s1] = 1;
      }
      code.build(lengths);
      return;
    }
    static const int kOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
    std::vector<int> cl(19, 0);
    const int n = static_cast<int>(br_.read(4)) + 4;
    for (int i = 0; i < n; ++i) cl[kOrder[i]] = static_cast<int>(br_.read(3));
    PrefixCode lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
      max_symbol = 2 + static_cast<int>(br_.read(nbits));
      if (max_symbol > alphabet) throw Error("bad VP8L code lengths");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lc.read(br_);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len != 0) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = len - 16;
        const int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > alphabet) throw Error("bad VP8L code lengths");
        const int v = len == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
      }
    }
    code.build(lengths);
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  static size_t plane_distance(int xsize, int code) {
    if (code > 120) return static_cast<size_t>(code - 120);
    const int d = kVp8lCodeToPlane[code - 1];
    const int dist = (d >> 4) * xsize + (8 - (d & 0xf));
    return static_cast<size_t>(dist >= 1 ? dist : 1);
  }

  static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  static uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t L, uint32_t T, uint32_t TL) {
    int pl = 0, pt = 0;  // distances of the estimate L + T - TL to L and to T
    for (int s = 0; s < 32; s += 8) {
      const int l = (L >> s) & 0xff, t = (T >> s) & 0xff, tl = (TL >> s) & 0xff;
      pl += std::abs(t - tl);
      pt += std::abs(l - tl);
    }
    return pl < pt ? L : T;
  }
  static uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int v = clip255(static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                            static_cast<int>((c >> s) & 0xff));
      out |= static_cast<uint32_t>(v) << s;
    }
    return out;
  }
  static uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = static_cast<int>((a >> s) & 0xff), y = static_cast<int>((b >> s) & 0xff);
      out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* cur, const uint32_t* top) {
    // cur points at the pixel, top at the pixel above it.
    const uint32_t L = cur[-1], T = top[0], TR = top[1], TL = top[-1];
    switch (mode) {
      case 0: return 0xff000000u;
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return average2(average2(L, TR), T);
      case 6: return average2(L, TL);
      case 7: return average2(L, T);
      case 8: return average2(TL, T);
      case 9: return average2(T, TR);
      case 10: return average2(average2(L, TL), average2(T, TR));
      case 11: return select(L, T, TL);
      case 12: return clamp_add_sub_full(L, T, TL);
      case 13: return clamp_add_sub_half(average2(L, T), TL);
      default: return 0xff000000u;  // 14 and 15: black, as libwebp's table
    }
  }

  static std::vector<uint32_t> inverse(const Vp8lTransform& t, std::vector<uint32_t>& in, int ysize) {
    const int w = t.xsize;
    switch (t.type) {
      case 0: {  // predictor
        std::vector<uint32_t>& p = in;
        const int tw = subsample(w, t.bits);
        p[0] = add_pixels(p[0], 0xff000000u);
        for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
        for (int y = 1; y < ysize; ++y) {
          uint32_t* row = &p[static_cast<size_t>(y) * w];
          const uint32_t* up = row - w;
          row[0] = add_pixels(row[0], up[0]);
          for (int x = 1; x < w; ++x) {
            const int mode = (t.data[(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 0xf;
            row[x] = add_pixels(row[x], predict(mode, row + x, up + x));
          }
        }
        return std::move(p);
      }
      case 1: {  // cross colour
        const int tw = subsample(w, t.bits);
        for (int y = 0; y < ysize; ++y) {
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[(y >> t.bits) * tw + (x >> t.bits)];
            const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
                         r2b = static_cast<int8_t>((m >> 16) & 0xff);
            uint32_t& argb = in[static_cast<size_t>(y) * w + x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int r = (argb >> 16) & 0xff, b = argb & 0xff;
            r = (r + ((g2r * green) >> 5)) & 0xff;
            b += (g2b * green) >> 5;
            b += (r2b * static_cast<int8_t>(r)) >> 5;
            b &= 0xff;
            argb = (argb & 0xff00ff00u) | (static_cast<uint32_t>(r) << 16) | static_cast<uint32_t>(b);
          }
        }
        return std::move(in);
      }
      case 2: {  // subtract green
        for (uint32_t& argb : in) {
          const uint32_t g = (argb >> 8) & 0xff;
          const uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
          argb = (argb & 0xff00ff00u) | rb;
        }
        return std::move(in);
      }
      default: {  // colour indexing: in is (ysize, packed width)
        const int pw = subsample(w, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
        const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
        for (int y = 0; y < ysize; ++y) {
          for (int x = 0; x < w; ++x) {
            const uint32_t packed = (in[static_cast<size_t>(y) * pw + x / per] >> 8) & 0xff;
            const int idx = t.bits ? (packed >> ((x % per) * bpp)) & mask : static_cast<int>(packed);
            out[static_cast<size_t>(y) * w + x] = t.data[idx];
          }
        }
        return out;
      }
    }
  }

  Vp8lBits br_;
};

}  // namespace

extern "C" {

// Width and height from the frame header of a JPEG.
int codec_jpeg_header(const uint8_t* data, size_t size, int* width, int* height, char* err,
                      int errlen) {
  try {
    Jpeg j(data, size);
    j.read_header();
    *width = j.width;
    *height = j.height;
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// Decode a JPEG into ``out``: height * width * 3 bytes of RGB.
int codec_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                      char* err, int errlen) {
  try {
    jpeg_decode(data, size, out, width, height);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// As codec_jpeg_decode, with the colour space of three components set by
// ``as_rgb`` (1: as stored, 0: YCbCr, -1: inferred), for JPEG-in-TIFF.
int codec_jpeg_decode_as(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                         int as_rgb, char* err, int errlen) {
  try {
    jpeg_decode(data, size, out, width, height, as_rgb);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// Unfilter inflated PNG image data (rows of a filter byte and the row, in
// seven passes when ``interlace`` is 1) and convert it into ``out``:
// height * width * 3 bytes of RGB.
int codec_png_decode(const uint8_t* data, size_t size, int width, int height, int color_type,
                     int bit_depth, int interlace, const uint8_t* palette, int palette_entries,
                     uint8_t* out, char* err, int errlen) {
  try {
    png_decode(data, size, width, height, color_type, bit_depth, interlace, palette,
               palette_entries, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// Resize an (h, w, 3) uint8 image into ``out``: nh * nw * 3 bytes.
int codec_resize_bilinear(const uint8_t* in, int h, int w, uint8_t* out, int nh, int nw, char* err,
                          int errlen) {
  try {
    resize_bilinear(in, h, w, out, nh, nw);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// The palette indices of a GIF frame (see gif_lzw) into ``out``, which
// holds width * height bytes and the fill for pixels the data misses.
int codec_gif_lzw(const uint8_t* data, size_t size, int min_code_size, int width, int height,
                  int interlace, uint8_t* out, char* err, int errlen) {
  try {
    gif_lzw(data, size, min_code_size, width, height, interlace != 0, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// A TIFF strip or tile: LZW (``kind`` 5) or PackBits (32773) into at most
// ``cap`` bytes of ``out``; ``written`` gets how many were written.
int codec_tiff_unpack(const uint8_t* data, size_t size, int kind, uint8_t* out, size_t cap,
                      size_t* written, char* err, int errlen) {
  try {
    if (kind == 5) {
      *written = tiff_lzw(data, size, out, cap);
    } else if (kind == 32773) {
      *written = packbits(data, size, out, cap);
    } else {
      throw Error("unknown TIFF compression");
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// A VP8 key frame (the payload of a WebP "VP8 " chunk) into ``out``:
// height * width * 3 bytes of RGB.
int codec_vp8_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                     char* err, int errlen) {
  try {
    vp8_decode(data, size, out, width, height);
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// A VP8L bitstream (the payload of a WebP "VP8L" chunk) into ``out``:
// height * width * 3 bytes of RGB; the alpha is dropped.
int codec_vp8l_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                      char* err, int errlen) {
  try {
    Vp8l dec(data, size);
    const std::vector<uint32_t> argb = dec.decode(width, height);
    for (size_t i = 0; i < argb.size(); ++i) {
      out[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
      out[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      out[3 * i + 2] = static_cast<uint8_t>(argb[i]);
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

}  // extern "C"
