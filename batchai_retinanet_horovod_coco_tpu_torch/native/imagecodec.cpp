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

void jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height) {
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
  const bool rgb = j.rgb_coded(), ycck = j.ycck_coded();
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

}  // extern "C"
