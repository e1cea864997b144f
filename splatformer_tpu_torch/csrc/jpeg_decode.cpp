// JPEG decoder for the host, exact to libjpeg-turbo 2.1.5 with the settings
// the JAX package decodes with (native/io.cc: JCS_RGB out, islow IDCT, fancy
// upsampling). The same arithmetic as the plain version in
// splatformer_tpu_torch/data/jpeg.py, which documents what is decoded, what
// is refused by name and how malformed data is reported; the standard
// library only (no jpeglib.h).
//
// C interface, loaded with ctypes (kernels/build.py compiles it with the
// host C++ compiler):
//   sf_jpeg_info(data, size, &w, &h)       -> 0 or an error code
//   sf_jpeg_decode(data, size, out, w, h)  -> 0 or an error code; out is a
//                                             caller-allocated h*w*3 uint8
//   sf_jpeg_message(code)                  -> the error's message
// Codes from 100 up name a variant that is refused, the others a malformed
// file or a failed allocation; no exception leaves the C interface.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code {
  kOk = 0,
  kNoSoi,
  kTruncatedSegment,
  kBadSof,
  kMultipleSof,
  kBadDht,
  kBadDqt,
  kBadDri,
  kBadSos,
  kSosBeforeSof,
  kBadComponentId,
  kBadSequentialScan,
  kBadProgressiveScan,
  kUnknownMarker,
  kNoImage,
  kBadHuffmanTable,
  kNoHuffmanTable,
  kNoQuantTable,
  kBadHuffmanCode,
  kDataEnds,
  kRestartOrder,
  kRestartCount,
  kPastBlockEnd,
  kBadRefinement,
  kNoScan,
  kSizeMismatch,
  kNoMemory,
  kInternal,
  kRefusedLossless = 100,
  kRefusedHierarchical,
  kRefusedArithmetic,
  kRefusedPrecision,
  kRefusedDnl,
  kRefusedCmyk,
  kRefusedYcck,
  kRefusedComponents,
  kRefusedSampling,
  kRefusedUnrefined,
};

const char* Message(int code) {
  switch (code) {
    case kOk: return "ok";
    case kNoSoi: return "no SOI marker";
    case kTruncatedSegment: return "truncated marker segment";
    case kBadSof: return "bad SOF segment";
    case kMultipleSof: return "more than one SOF marker";
    case kBadDht: return "bad DHT segment";
    case kBadDqt: return "bad DQT segment";
    case kBadDri: return "bad DRI segment";
    case kBadSos: return "bad SOS segment";
    case kSosBeforeSof: return "SOS before SOF";
    case kBadComponentId: return "bad component id in SOS";
    case kBadSequentialScan: return "bad sequential scan parameters";
    case kBadProgressiveScan: return "bad progressive scan parameters";
    case kUnknownMarker: return "unknown marker";
    case kNoImage: return "no image data";
    case kBadHuffmanTable: return "bad Huffman table";
    case kNoHuffmanTable: return "Huffman table is not defined";
    case kNoQuantTable: return "quantisation table is not defined";
    case kBadHuffmanCode: return "bad Huffman code";
    case kDataEnds: return "entropy-coded data ends early";
    case kRestartOrder: return "restart marker out of order";
    case kRestartCount:
      return "restart markers do not match the restart interval";
    case kPastBlockEnd: return "coefficient past the block's end";
    case kBadRefinement: return "bad refinement coefficient";
    case kNoScan: return "a component has no scan";
    case kSizeMismatch: return "output size does not match the image";
    case kNoMemory: return "out of memory";
    case kInternal: return "internal decoder error";
    case kRefusedLossless: return "lossless JPEG (SOF3)";
    case kRefusedHierarchical: return "hierarchical JPEG (SOF5-7, SOF13-15)";
    case kRefusedArithmetic:
      return "arithmetic coding (SOF9-11, SOF13-15, DAC)";
    case kRefusedPrecision:
      return "sample precision other than 8 bits (only 8-bit is decoded)";
    case kRefusedDnl: return "DNL marker (image height in a DNL segment)";
    case kRefusedCmyk: return "CMYK colour (4 components)";
    case kRefusedYcck: return "YCCK colour (4 components)";
    case kRefusedComponents:
      return "component count other than 1 and 3";
    case kRefusedSampling:
      return "sampling factors (decoded: 4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0 "
             "and grey 1x1)";
    case kRefusedUnrefined:
      return "progressive file whose scans leave coefficients unrefined "
             "(libjpeg smooths those blocks)";
    default: return "unknown error";
  }
}

struct Fail {
  int code;
};

[[noreturn]] void Throw(int code) { throw Fail{code}; }

// zig-zag index -> natural position
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------------- Huffman
constexpr int kFastBits = 10;

struct Huffman {
  bool defined = false;
  int max_symbol = 0;
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol, 0 if longer
  int32_t maxcode[18];            // largest code of each length, -1 if none
  int32_t valoffset[18];          // symbol index of a code of that length
  uint8_t vals[256];

  // jdhuff.c:jpeg_make_d_derived_tbl
  void Build(const uint8_t* counts, const uint8_t* symbols, int total) {
    std::memcpy(vals, symbols, total);
    std::memset(fast, 0, sizeof(fast));
    max_symbol = 0;
    for (int i = 0; i < total; ++i)
      max_symbol = std::max(max_symbol, int(symbols[i]));
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      int n = counts[len - 1];
      // no code may be all ones: the last code must still fit in len bits
      // (checked before the writes below, which it keeps inside fast)
      if (code + n >= (1 << len)) Throw(kBadHuffmanTable);
      valoffset[len] = k - code;
      maxcode[len] = n ? code + n - 1 : -1;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (len <= kFastBits) {
          int shift = kFastBits - len;
          uint16_t e = uint16_t((len << 8) | symbols[k]);
          for (int j = 0; j < (1 << shift); ++j) fast[(code << shift) | j] = e;
        }
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

// ---------------------------------------------------------- bit reader
// Extra zero bytes after an interval's data: one block reads at most 64
// codes of 16 + 15 bits (plus correction bits), checked after each block.
constexpr size_t kPad = 336;

struct Bits {
  const uint8_t* buf = nullptr;
  size_t nbits = 0;
  size_t pos = 0;

  // the next 57 or more bits, most significant first
  inline uint64_t Peek() const {
    uint64_t v;
    std::memcpy(&v, buf + (pos >> 3), 8);
    return __builtin_bswap64(v) << (pos & 7);
  }
  inline int Decode(const Huffman& h) {
    uint64_t v = Peek();
    uint32_t top = uint32_t(v >> 48);
    uint16_t e = h.fast[top >> (16 - kFastBits)];
    if (e) {
      pos += e >> 8;
      return e & 255;
    }
    int len = kFastBits + 1;
    while (int32_t(top >> (16 - len)) > h.maxcode[len]) {
      if (++len > 16) Throw(kBadHuffmanCode);
    }
    pos += len;
    return h.vals[h.valoffset[len] + int32_t(top >> (16 - len))];
  }
  inline int Get(int n) {
    if (n == 0) return 0;
    uint64_t v = Peek();
    pos += n;
    return int(v >> (64 - n));
  }
  inline int Bit() {
    int b = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  inline void Check() const {
    if (pos > nbits) Throw(kDataEnds);
  }
};

inline int Extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// ------------------------------------------------------------- decoder
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  bool latched = false;
  int32_t quant[64];  // natural order, as ISLOW_MULT_TYPE (short)
  int w = 0, hgt = 0, wb = 0, hb = 0, bw = 0, bh = 0;
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int pred = 0;
  int coef_bits[64];
};

struct ScanComp {
  Component* c;
  int td, ta;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  Huffman dc[4], ac[4];
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  bool have_sof = false, progressive = false;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int scans = 0;
  std::vector<uint8_t> scratch;

  Decoder(const uint8_t* d, size_t size) : data(d), n(size) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) Throw(kNoSoi);
  }

  // jdmarker.c:next_marker; -1 at the end of the data
  int NextMarker(size_t* pos) {
    size_t p = *pos;
    for (;;) {
      while (p < n && data[p] != 0xFF) ++p;
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n) {
        *pos = n;
        return -1;
      }
      int code = data[p++];
      if (code != 0) {
        *pos = p;
        return code;
      }
    }
  }

  void Run(bool header_only) {
    size_t pos = 2;
    for (;;) {
      int code = NextMarker(&pos);
      if (code == 0xD9 || code < 0) {
        if (!scans) Throw(kNoImage);
        return;
      }
      if ((code >= 0xD0 && code <= 0xD7) || code == 0x01) continue;
      switch (code) {
        case 0xC3: Throw(kRefusedLossless);
        case 0xC5: case 0xC6: case 0xC7: Throw(kRefusedHierarchical);
        case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE:
        case 0xCF: Throw(kRefusedArithmetic);
        case 0xDC: Throw(kRefusedDnl);
        default: break;
      }
      if (pos + 2 > n) Throw(kTruncatedSegment);
      size_t len = (size_t(data[pos]) << 8) | data[pos + 1];
      if (len < 2 || pos + len > n) Throw(kTruncatedSegment);
      const uint8_t* p = data + pos + 2;
      size_t plen = len - 2;
      pos += len;
      if (code == 0xC0 || code == 0xC1 || code == 0xC2) {
        Sof(code, p, plen);
      } else if (code == 0xC4) {
        Dht(p, plen);
      } else if (code == 0xDB) {
        Dqt(p, plen);
      } else if (code == 0xDD) {
        if (plen < 2) Throw(kBadDri);
        restart = (p[0] << 8) | p[1];
      } else if (code == 0xDA) {
        std::vector<ScanComp> sc;
        int ss, se, ah, al;
        Sos(p, plen, &sc, &ss, &se, &ah, &al);
        if (scans == 0) {
          CheckColour();
          if (header_only) return;
        }
        pos = DecodeScan(sc, ss, se, ah, al, pos);
        ++scans;
      } else if (code == 0xE0) {
        if (plen >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
      } else if (code == 0xEE) {
        if (plen >= 12 && std::memcmp(p, "Adobe", 5) == 0) adobe = p[11];
      } else if ((code >= 0xE1 && code <= 0xEF) || code == 0xFE) {
      } else {
        Throw(kUnknownMarker);
      }
    }
  }

  void Sof(int code, const uint8_t* p, size_t len) {
    if (have_sof) Throw(kMultipleSof);
    if (len < 6) Throw(kBadSof);
    if (p[0] != 8) Throw(kRefusedPrecision);
    height = (p[1] << 8) | p[2];
    width = (p[3] << 8) | p[4];
    int nc = p[5];
    if (height == 0) Throw(kRefusedDnl);
    if (width == 0 || nc == 0 || len < size_t(6 + 3 * nc)) Throw(kBadSof);
    progressive = code == 0xC2;
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        Throw(kBadSof);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_sof = true;
  }

  // jdapimin.c:default_decompress_parms' colour space, and the component
  // sets that are decoded
  void CheckColour() {
    int nc = int(comps.size());
    if (nc == 4) Throw(adobe == 2 ? kRefusedYcck : kRefusedCmyk);
    if (nc != 1 && nc != 3) Throw(kRefusedComponents);
    bool ok;
    if (nc == 1) {
      ok = comps[0].h == 1 && comps[0].v == 1;
    } else {
      int h0 = comps[0].h, v0 = comps[0].v;
      ok = comps[1].h == 1 && comps[1].v == 1 && comps[2].h == 1 &&
           comps[2].v == 1 &&
           ((h0 == 1 && v0 == 1) || (h0 == 2 && v0 == 1) ||
            (h0 == 2 && v0 == 2) || (h0 == 4 && v0 == 1) ||
            (h0 == 1 && v0 == 2));
    }
    if (!ok) Throw(kRefusedSampling);
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.w = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.hgt = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wb = (c.w + 7) / 8;
      c.hb = (c.hgt + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
  }

  bool IsRgb() const {
    if (jfif) return false;
    if (adobe >= 0) return adobe == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }

  void Dht(const uint8_t* p, size_t len) {
    size_t pos = 0;
    while (pos < len) {
      if (pos + 17 > len) Throw(kBadDht);
      int tc = p[pos] >> 4, th = p[pos] & 15;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += p[pos + 1 + i];
      if (tc > 1 || th > 3 || total > 256 || pos + 17 + total > len)
        Throw(kBadDht);
      (tc ? ac : dc)[th].Build(p + pos + 1, p + pos + 17, total);
      pos += 17 + total;
    }
  }

  void Dqt(const uint8_t* p, size_t len) {
    size_t pos = 0;
    while (pos < len) {
      int pq = p[pos] >> 4, tq = p[pos] & 15;
      size_t size = pq ? 128 : 64;
      if (pq > 1 || tq > 3 || pos + 1 + size > len) Throw(kBadDqt);
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (p[pos + 1 + 2 * k] << 8) | p[pos + 2 + 2 * k]
                   : p[pos + 1 + k];
        qt[tq][kZigzag[k]] = int16_t(uint16_t(v));  // a short, as libjpeg
      }
      qt_defined[tq] = true;
      pos += 1 + size;
    }
  }

  void Sos(const uint8_t* p, size_t len, std::vector<ScanComp>* sc, int* ss,
           int* se, int* ah, int* al) {
    if (!have_sof) Throw(kSosBeforeSof);
    if (len < 1 || len < size_t(1 + 2 * p[0] + 3)) Throw(kBadSos);
    int ns = p[0];
    if (ns < 1 || ns > int(comps.size())) Throw(kBadSos);
    for (int i = 0; i < ns; ++i) {
      int id = p[1 + 2 * i], t = p[2 + 2 * i];
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) Throw(kBadComponentId);
      for (auto& s : *sc)
        if (s.c == found) Throw(kBadComponentId);
      sc->push_back({found, t >> 4, t & 15});
    }
    *ss = p[1 + 2 * ns];
    *se = p[2 + 2 * ns];
    *ah = p[3 + 2 * ns] >> 4;
    *al = p[3 + 2 * ns] & 15;
    if (!progressive) {
      if (*ss != 0 || *se != 63 || *ah != 0 || *al != 0)
        Throw(kBadSequentialScan);
    } else {
      bool bad = *se < *ss || *se > 63 || *al > 13 ||
                 (*ss == 0 && *se != 0) || (*ss > 0 && ns != 1) ||
                 (*ah && *ah != *al + 1);
      if (bad) Throw(kBadProgressiveScan);
    }
  }

  // One restart interval's entropy-coded bytes, stuffing removed, into
  // scratch. Returns the position after it and the marker that ends it
  // (-1 where the file ends without EOI).
  size_t Interval(size_t pos, int* marker) {
    scratch.clear();
    for (;;) {
      const uint8_t* f = static_cast<const uint8_t*>(
          std::memchr(data + pos, 0xFF, n - pos));
      size_t j = f ? size_t(f - data) : n;
      scratch.insert(scratch.end(), data + pos, data + j);
      size_t k = j + 1;
      while (k < n && data[k] == 0xFF) ++k;
      if (k >= n) {
        *marker = -1;
        return n;
      }
      if (data[k] == 0) {
        scratch.push_back(0xFF);
        pos = k + 1;
        continue;
      }
      *marker = data[k];
      return (data[k] >= 0xD0 && data[k] <= 0xD7) ? k + 1 : j;
    }
  }

  size_t DecodeScan(std::vector<ScanComp>& sc, int ss, int se, int ah, int al,
                    size_t pos) {
    for (auto& s : sc) {
      Component& c = *s.c;
      if (!c.latched) {
        if (!qt_defined[c.tq]) Throw(kNoQuantTable);
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        c.latched = true;
      }
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      // a selector is checked where the scan uses it, as libjpeg does
      if (ss == 0 && ah == 0) {
        if (s.td > 3 || !dc[s.td].defined) Throw(kNoHuffmanTable);
        if (dc[s.td].max_symbol > 15) Throw(kBadHuffmanTable);
      }
      if (se > 0 && (s.ta > 3 || !ac[s.ta].defined)) Throw(kNoHuffmanTable);
    }
    // the scan's blocks in MCU order: (component, block index)
    std::vector<std::pair<int, int>> units;
    int per_mcu;
    if (sc.size() == 1) {
      Component& c = *sc[0].c;
      int ci = int(&c - comps.data());
      units.reserve(size_t(c.wb) * c.hb);
      for (int r = 0; r < c.hb; ++r)
        for (int x = 0; x < c.wb; ++x) units.push_back({ci, r * c.bw + x});
      per_mcu = 1;
    } else {
      per_mcu = 0;
      for (auto& s : sc) per_mcu += s.c->h * s.c->v;
      units.reserve(size_t(mcux) * mcuy * per_mcu);
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx)
          for (auto& s : sc) {
            Component& c = *s.c;
            int ci = int(&c - comps.data());
            for (int dy = 0; dy < c.v; ++dy)
              for (int dx = 0; dx < c.h; ++dx)
                units.push_back(
                    {ci, (my * c.v + dy) * c.bw + mx * c.h + dx});
          }
    }
    size_t total = units.size() / per_mcu;
    size_t per = restart ? size_t(restart) : total;
    size_t done = 0;
    int expect = 0;
    for (;;) {
      int marker = 0;
      size_t next = Interval(pos, &marker);
      if (done >= total) Throw(kRestartCount);
      size_t count = std::min(per, total - done);
      size_t nbytes = scratch.size();
      scratch.resize(nbytes + kPad, 0);
      Bits br;
      br.buf = scratch.data();
      br.nbits = 8 * nbytes;
      for (auto& s : sc) s.c->pred = 0;
      const std::pair<int, int>* u = units.data() + done * per_mcu;
      size_t nu = count * per_mcu;
      if (!progressive)
        Sequential(br, u, nu, sc);
      else if (ss == 0 && ah == 0)
        DcFirst(br, u, nu, sc, al);
      else if (ss == 0)
        DcRefine(br, u, nu, al);
      else if (ah == 0)
        AcFirst(br, u, nu, sc[0], ss, se, al);
      else
        AcRefine(br, u, nu, sc[0], ss, se, al);
      done += count;
      bool rst = marker >= 0xD0 && marker <= 0xD7;
      if (!rst) {
        if (done != total) Throw(kRestartCount);
        return next;
      }
      if (marker - 0xD0 != expect) Throw(kRestartOrder);
      expect = (expect + 1) & 7;
      pos = next;
    }
  }

  int Table(const std::vector<ScanComp>& sc, int ci, bool is_ac) const {
    for (auto& s : sc)
      if (s.c == &comps[ci]) return is_ac ? s.ta : s.td;
    return 0;
  }

  // jdhuff.c:decode_mcu
  void Sequential(Bits& br, const std::pair<int, int>* u, size_t nu,
                  const std::vector<ScanComp>& sc) {
    const Huffman* dct[4];
    const Huffman* act[4];
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      dct[ci] = &dc[Table(sc, int(ci), false)];
      act[ci] = &ac[Table(sc, int(ci), true)];
    }
    for (size_t i = 0; i < nu; ++i) {
      Component& c = comps[u[i].first];
      int16_t* blk = c.coef.data() + size_t(u[i].second) * 64;
      const Huffman& dh = *dct[u[i].first];
      const Huffman& ah = *act[u[i].first];
      int s = br.Decode(dh);
      int diff = s ? Extend(br.Get(s), s) : 0;
      c.pred = int(unsigned(c.pred) + unsigned(diff));
      blk[0] = int16_t(c.pred);
      for (int k = 1; k < 64;) {
        int rs = br.Decode(ah);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) Throw(kPastBlockEnd);
          blk[kZigzag[k]] = int16_t(Extend(br.Get(s), s));
          ++k;
        } else {
          if (r != 15) break;
          k += 16;
        }
      }
      br.Check();
    }
  }

  // jdphuff.c:decode_mcu_DC_first
  void DcFirst(Bits& br, const std::pair<int, int>* u, size_t nu,
               const std::vector<ScanComp>& sc, int al) {
    for (size_t i = 0; i < nu; ++i) {
      Component& c = comps[u[i].first];
      int s = br.Decode(dc[Table(sc, u[i].first, false)]);
      int diff = s ? Extend(br.Get(s), s) : 0;
      c.pred = int(unsigned(c.pred) + unsigned(diff));
      c.coef[size_t(u[i].second) * 64] = int16_t(unsigned(c.pred) << al);
      br.Check();
    }
  }

  // jdphuff.c:decode_mcu_DC_refine
  void DcRefine(Bits& br, const std::pair<int, int>* u, size_t nu, int al) {
    for (size_t i = 0; i < nu; ++i) {
      int16_t* blk = comps[u[i].first].coef.data() + size_t(u[i].second) * 64;
      if (br.Bit()) blk[0] = int16_t(blk[0] | (1 << al));
      br.Check();
    }
  }

  // jdphuff.c:decode_mcu_AC_first
  void AcFirst(Bits& br, const std::pair<int, int>* u, size_t nu,
               const ScanComp& s, int ss, int se, int al) {
    const Huffman& h = ac[s.ta];
    unsigned eobrun = 0;
    for (size_t i = 0; i < nu; ++i) {
      if (eobrun) {
        --eobrun;
        continue;
      }
      int16_t* blk = comps[u[i].first].coef.data() + size_t(u[i].second) * 64;
      for (int k = ss; k <= se;) {
        int rs = br.Decode(h);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > 63) Throw(kPastBlockEnd);
          blk[kZigzag[k]] = int16_t(unsigned(Extend(br.Get(sz), sz)) << al);
          ++k;
        } else if (r == 15) {
          k += 16;
        } else {
          eobrun = (1u << r) + unsigned(br.Get(r)) - 1;
          break;
        }
      }
      br.Check();
    }
  }

  // jdphuff.c:decode_mcu_AC_refine
  void AcRefine(Bits& br, const std::pair<int, int>* u, size_t nu,
                const ScanComp& s, int ss, int se, int al) {
    const Huffman& h = ac[s.ta];
    const int p1 = 1 << al, m1 = -(1 << al);
    unsigned eobrun = 0;
    for (size_t i = 0; i < nu; ++i) {
      int16_t* blk = comps[u[i].first].coef.data() + size_t(u[i].second) * 64;
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.Decode(h);
          int r = rs >> 4, sz = rs & 15;
          int val = 0;
          if (sz) {
            if (sz != 1) Throw(kBadRefinement);
            val = br.Bit() ? p1 : m1;
          } else if (r != 15) {
            eobrun = (1u << r) + unsigned(br.Get(r));
            break;
          }
          while (k <= se) {
            int16_t* t = blk + kZigzag[k];
            if (*t != 0) {
              if (br.Bit() && (*t & p1) == 0)
                *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
            } else if (--r < 0) {
              break;
            }
            ++k;
          }
          if (val) {
            if (k > 63) Throw(kPastBlockEnd);
            blk[kZigzag[k]] = int16_t(val);
          }
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* t = blk + kZigzag[k];
          if (*t != 0 && br.Bit() && (*t & p1) == 0)
            *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
        }
        --eobrun;
      }
      br.Check();
    }
  }

  void Output(uint8_t* out);
};

// ------------------------------------------------------------------ IDCT
// jidctint.c:jpeg_idct_islow, CONST_BITS 13, PASS1_BITS 2
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// post-IDCT range limit (jdmaster.c:prepare_range_limit_table), by x & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? uint8_t(i + 128)
             : i < 512 ? 255
             : i < 896 ? 0
                       : uint8_t(i - 896);
  }
};
const RangeLimit kLimit;

// 8 inputs x[0], x[stride], ... -> 8 outputs descaled by `shift`
template <typename In>
inline void Idct1d(const In* x, int stride, int shift, int64_t* o) {
  int64_t z2 = x[2 * stride], z3 = x[6 * stride];
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 - z3 * F1847;
  int64_t tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = (int64_t(x[0]) + x[4 * stride]) * 8192;
  int64_t tmp1 = (int64_t(x[0]) - x[4 * stride]) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7 * stride], t1 = x[5 * stride], t2 = x[3 * stride],
          t3 = x[1 * stride];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = int64_t(1) << (shift - 1);
  o[0] = (tmp10 + t3 + half) >> shift;
  o[7] = (tmp10 - t3 + half) >> shift;
  o[1] = (tmp11 + t2 + half) >> shift;
  o[6] = (tmp11 - t2 + half) >> shift;
  o[2] = (tmp12 + t1 + half) >> shift;
  o[5] = (tmp12 - t1 + half) >> shift;
  o[3] = (tmp13 + t0 + half) >> shift;
  o[4] = (tmp13 - t0 + half) >> shift;
}

// A column or row whose AC terms are all zero takes jidctint.c's shortcut,
// which equals the full computation: a column gives 4 x its DC term
// (DESCALE(dc << 13, 11)), a row DESCALE(dc, 5) in all eight places.
void IdctBlock(const int16_t* coef, const int32_t* quant, uint8_t* out,
               size_t stride) {
  int32_t in[64];
  for (int i = 0; i < 64; ++i) in[i] = int32_t(coef[i]) * quant[i];
  int32_t ws[64];  // libjpeg's int workspace
  int64_t o[8];
  for (int col = 0; col < 8; ++col) {
    const int32_t* c = in + col;
    if ((c[8] | c[16] | c[24] | c[32] | c[40] | c[48] | c[56]) == 0) {
      int32_t dc = int32_t(uint32_t(c[0]) << 2);
      for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
      continue;
    }
    Idct1d(c, 8, 11, o);
    for (int r = 0; r < 8; ++r) ws[r * 8 + col] = int32_t(o[r]);
  }
  for (int row = 0; row < 8; ++row) {
    const int32_t* w = ws + row * 8;
    uint8_t* dst = out + row * stride;
    if ((w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7]) == 0) {
      std::memset(dst, kLimit.t[((int64_t(w[0]) + 16) >> 5) & 1023], 8);
      continue;
    }
    Idct1d(w, 1, 18, o);
    for (int x = 0; x < 8; ++x) dst[x] = kLimit.t[o[x] & 1023];
  }
}

// ------------------------------------------------------ upsample, colour
struct Ycc {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  Ycc() {
    auto fix = [](double v) { return int32_t(v * 65536 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + 32768) >> 16;
      cb_b[i] = (fix(1.77200) * x + 32768) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};
const Ycc kYcc;

inline uint8_t Clamp(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// One output row of a component upsampled to the image's width (jdsample.c).
void UpsampleRow(const uint8_t* plane, size_t stride, int cw, int ch, int fh,
                 int fv, int y, int width, uint8_t* dst, int32_t* sums) {
  if (fh == 1 && fv == 1) {
    std::memcpy(dst, plane + size_t(y) * stride, size_t(width));
    return;
  }
  int r = y / fv;
  const uint8_t* x = plane + size_t(r) * stride;
  bool fancy = cw > 2;
  if (fancy && fh == 2 && fv == 1) {  // h2v1_fancy_upsample
    for (int i = 0; i < cw; ++i) {
      int c = 3 * x[i];
      int left = x[i > 0 ? i - 1 : 0], right = x[i < cw - 1 ? i + 1 : i];
      int o = 2 * i;
      if (o < width) dst[o] = uint8_t((c + left + 1) >> 2);
      if (o + 1 < width) dst[o + 1] = uint8_t((c + right + 2) >> 2);
    }
  } else if (fancy && fh == 2 && fv == 2) {  // h2v2_fancy_upsample
    int rn = (y & 1) ? std::min(r + 1, ch - 1) : std::max(r - 1, 0);
    const uint8_t* xn = plane + size_t(rn) * stride;
    for (int i = 0; i < cw; ++i) sums[i] = 3 * x[i] + xn[i];
    for (int i = 0; i < cw; ++i) {
      int c = 3 * sums[i];
      int left = sums[i > 0 ? i - 1 : 0], right = sums[i < cw - 1 ? i + 1 : i];
      int o = 2 * i;
      if (o < width) dst[o] = uint8_t((c + left + 8) >> 4);
      if (o + 1 < width) dst[o + 1] = uint8_t((c + right + 7) >> 4);
    }
  } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    int rn, bias;
    if (y & 1) {
      rn = std::min(r + 1, ch - 1);
      bias = 2;
    } else {
      rn = std::max(r - 1, 0);
      bias = 1;
    }
    const uint8_t* xn = plane + size_t(rn) * stride;
    for (int i = 0; i < width; ++i)
      dst[i] = uint8_t((3 * x[i] + xn[i] + bias) >> 2);
  } else {  // h2v1_upsample, h2v2_upsample, int_upsample
    for (int o = 0; o < width; ++o) dst[o] = x[o / fh];
  }
}

void Decoder::Output(uint8_t* out) {
  for (auto& c : comps) {
    if (!c.latched) Throw(kNoScan);
    if (progressive)
      for (int k = 0; k < 10; ++k)  // jdcoefct.c:smoothing_ok, SAVED_COEFS
        if (c.coef_bits[k] != 0) Throw(kRefusedUnrefined);
  }
  int nc = int(comps.size());
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<size_t> strides(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = comps[ci];
    strides[ci] = size_t(c.wb) * 8;
    planes[ci].resize(strides[ci] * size_t(c.hb) * 8);
    for (int by = 0; by < c.hb; ++by)
      for (int bx = 0; bx < c.wb; ++bx)
        IdctBlock(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant,
                  planes[ci].data() + size_t(by) * 8 * strides[ci] + bx * 8,
                  strides[ci]);
  }
  std::vector<uint8_t> rows(size_t(nc) * (width + 8));
  std::vector<int32_t> sums(size_t(width) + 8);
  bool rgb = nc == 3 && IsRgb();
  for (int y = 0; y < height; ++y) {
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps[ci];
      UpsampleRow(planes[ci].data(), strides[ci], c.w, c.hgt, hmax / c.h,
                  vmax / c.v, y, width, rows.data() + size_t(ci) * (width + 8),
                  sums.data());
    }
    uint8_t* dst = out + size_t(y) * width * 3;
    const uint8_t* r0 = rows.data();
    if (nc == 1) {
      for (int x = 0; x < width; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = r0[x];
      continue;
    }
    const uint8_t* r1 = r0 + (width + 8);
    const uint8_t* r2 = r1 + (width + 8);
    if (rgb) {
      for (int x = 0; x < width; ++x) {
        dst[3 * x] = r0[x];
        dst[3 * x + 1] = r1[x];
        dst[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < width; ++x) {  // jdcolor.c:ycc_rgb_convert
      int yy = r0[x], cb = r1[x], cr = r2[x];
      dst[3 * x] = Clamp(yy + kYcc.cr_r[cr]);
      dst[3 * x + 1] = Clamp(yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      dst[3 * x + 2] = Clamp(yy + kYcc.cb_b[cb]);
    }
  }
}

}  // namespace

extern "C" {

int sf_jpeg_info(const char* data, size_t size, int* w, int* h) {
  try {
    Decoder d(reinterpret_cast<const uint8_t*>(data), size);
    d.Run(true);
    *w = d.width;
    *h = d.height;
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kInternal;
  }
}

int sf_jpeg_decode(const char* data, size_t size, uint8_t* out, int w,
                   int h) {
  try {
    Decoder d(reinterpret_cast<const uint8_t*>(data), size);
    d.Run(false);
    if (d.width != w || d.height != h) return kSizeMismatch;
    d.Output(out);
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kInternal;
  }
}

const char* sf_jpeg_message(int code) { return Message(code); }

}  // extern "C"
