"""JPEG decoding, exact to the libjpeg-turbo 2.1.5 that the JAX package
decodes through (native/io.cc: ``out_color_space = JCS_RGB`` and otherwise
libjpeg's defaults).

Two decoders with the same arithmetic:

* ``decode_jpeg_plain(data)``: numpy and pure Python, the oracle;
* ``decode_jpeg(data)``: csrc/jpeg_decode.cpp, compiled with the host C++
  compiler at first use (kernels/build.py) and called through ctypes, which
  releases the interpreter lock while it decodes. A failed build or load
  raises; nothing falls back to the plain version.

Both return uint8 (H, W, 3). What they compute, after libjpeg-turbo:

* baseline and extended sequential Huffman (SOF0, SOF1) files, their
  scans interleaved or one component each, and progressive Huffman (SOF2)
  files, 8-bit, restart intervals included; DQT tables of 8 and 16 bits,
  DHT tables redefined between scans;
* dequantisation through the zig-zag order and the islow integer IDCT
  (jidctint.c) into the post-IDCT range-limit table (jdmaster.c), indexed
  ``& 1023``;
* upsampling as jdsample.c does it: h2v1 and h2v2 fancy (triangle) when
  the component is wider than 2 samples, h1v2 fancy always, plain
  replication otherwise (int_upsample for 4:1:1), the last real row and
  column repeated at the edges;
* ycc_rgb_convert's fixed point (jdcolor.c) for YCbCr; no conversion for
  RGB (an Adobe marker with transform 0, or components 'R', 'G', 'B' and
  no JFIF marker); grey replicated to RGB.

Refused by name (NotImplementedError): arithmetic coding (SOF9-11, DAC),
lossless (SOF3) and hierarchical (SOF5-7, SOF13-15) files, sample precision
other than 8 bits, CMYK and YCCK, component counts other than 1 and 3,
sampling factors other than 4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0 (grey
1x1), DNL, and a progressive file that leaves coefficients unrefined.

Departure from libjpeg: truncated or corrupt entropy data (a code that is
not in its table, a scan that ends early, a missing or misnumbered restart
marker, a coefficient past the block's end) raises IOError, where
libjpeg-turbo warns and fills with zeros. Malformed segments (an
over-subscribed Huffman table, a table selector past 3, a scan of no
components) raise IOError, as libjpeg stops on them; so does a failed
allocation in the compiled decoder.
"""
from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# zig-zag index -> natural (row-major 8x8) position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = ZIGZAG.tolist()

# the sampling factors (h, v) of each component that are decoded: grey,
# 4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0
SAMPLINGS = {((1, 1),), ((1, 1), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
             ((2, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
             ((1, 2), (1, 1), (1, 1))}

_SOF_REFUSED = {0xC3: "lossless JPEG (SOF3)",
                0xC5: "hierarchical JPEG (SOF5)",
                0xC6: "hierarchical JPEG (SOF6)",
                0xC7: "hierarchical JPEG (SOF7)",
                0xC9: "arithmetic coding (SOF9)",
                0xCA: "arithmetic coding (SOF10)",
                0xCB: "arithmetic coding (SOF11)",
                0xCC: "arithmetic coding (DAC)",
                0xCD: "arithmetic coding (SOF13)",
                0xCE: "arithmetic coding (SOF14)",
                0xCF: "arithmetic coding (SOF15)",
                0xDC: "DNL marker (image height in a DNL segment)"}

# jidctint.c's constants, FIX(x) at CONST_BITS 13
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit_idct() -> np.ndarray:
    """jdmaster.c:prepare_range_limit_table seen from IDCT_range_limit: the
    entry for ``x & 1023`` of a centred sample x."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_IDCT_LIMIT = _range_limit_idct()


def _ycc_tables() -> Tuple[np.ndarray, ...]:
    """jdcolor.c:build_ycc_rgb_table at SCALEBITS 16."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "w", "hgt", "bw", "bh",
                 "wb", "hb", "blocks", "dc_pred", "coef_bits")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None   # latched at its 1st scan
        self.blocks: Optional[List[List[int]]] = None
        # progressive: the point transform each coefficient was last sent
        # at, -1 before any scan (libjpeg's coef_bits)
        self.coef_bits = [-1] * 64


def _huffman_lut(counts: List[int], symbols: bytes) -> List[int]:
    """jdhuff.c:jpeg_make_d_derived_tbl as a lookup on the next 16 bits:
    entry (length << 8) | symbol, 0 where no code starts."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        # no code may be all ones: the last code must still fit in length
        # bits (checked before the writes below, which it keeps in the lut)
        if code + counts[length - 1] >= 1 << length:
            raise IOError("JPEG: bad Huffman table")
        for _ in range(counts[length - 1]):
            shift = 16 - length
            start = code << shift
            lut[start:start + (1 << shift)] = \
                [(length << 8) | symbols[k]] * (1 << shift)
            code += 1
            k += 1
        code <<= 1
    return lut


class _Huffman:
    __slots__ = ("lut", "max_symbol")

    def __init__(self, counts: List[int], symbols: bytes):
        self.lut = _huffman_lut(counts, symbols)
        self.max_symbol = max(symbols) if symbols else 0


_STUFFED = re.compile(rb"\xff+\x00")
# extra zero bytes after a restart interval's data: a block reads at most
# 64 codes of 16 + 15 bits, so an interval that ends early is caught after
# its block without reading past the buffer
_PAD = bytes(320)


class _BitReader:
    """The entropy-coded bits of one restart interval, stuffing removed."""
    __slots__ = ("buf", "pos", "nbits")

    def __init__(self, raw: bytes):
        data = _STUFFED.sub(b"\xff", raw)
        self.buf = data + _PAD
        self.nbits = 8 * len(data)
        self.pos = 0

    def check(self) -> None:
        if self.pos > self.nbits:
            raise IOError("JPEG: entropy-coded data ends early")


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < 1 << (s - 1) else r


def _wrap16(x: int) -> int:
    """The JCOEF (16-bit) store of a coefficient."""
    return ((x + 32768) & 0xFFFF) - 32768


class _Decoder:
    def __init__(self, data: bytes):
        if data[:2] != b"\xff\xd8":
            raise IOError("JPEG: no SOI marker")
        self.data = data
        self.qt: Dict[int, np.ndarray] = {}
        self.ht: Dict[Tuple[int, int], _Huffman] = {}
        self.restart = 0
        self.jfif = False
        self.adobe: Optional[int] = None
        self.comps: List[_Component] = []
        self.progressive: Optional[bool] = None
        self.width = self.height = 0
        self.scans = 0

    # -------------------------------------------------------- markers
    def _next_marker(self, pos: int) -> Tuple[int, int]:
        """jdmarker.c:next_marker: skip to an 0xFF, then its fill bytes."""
        data, n = self.data, len(self.data)
        while True:
            pos = data.find(b"\xff", pos)
            if pos < 0:
                return -1, n
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                return -1, n
            code = data[pos]
            pos += 1
            if code != 0:
                return code, pos

    def _segment(self, pos: int) -> Tuple[bytes, int]:
        if pos + 2 > len(self.data):
            raise IOError("JPEG: truncated marker segment")
        length = int.from_bytes(self.data[pos:pos + 2], "big")
        if length < 2 or pos + length > len(self.data):
            raise IOError("JPEG: truncated marker segment")
        return self.data[pos + 2:pos + length], pos + length

    def run(self) -> None:
        pos = 2
        while True:
            code, pos = self._next_marker(pos)
            if code == 0xD9 or code < 0:     # EOI, or the data ends
                if not self.scans:
                    raise IOError("JPEG: no image data")
                return
            if 0xD0 <= code <= 0xD7 or code == 0x01:
                continue                     # parameterless, ignored
            if code in _SOF_REFUSED:
                raise NotImplementedError(f"JPEG: {_SOF_REFUSED[code]}")
            payload, pos = self._segment(pos)
            if code in (0xC0, 0xC1, 0xC2):
                self._sof(code, payload)
            elif code == 0xC4:
                self._dht(payload)
            elif code == 0xDB:
                self._dqt(payload)
            elif code == 0xDD:
                if len(payload) < 2:
                    raise IOError("JPEG: bad DRI segment")
                self.restart = int.from_bytes(payload[:2], "big")
            elif code == 0xDA:
                scan = self._sos(payload)
                if self.scans == 0:
                    self._check_colour()
                pos = self._decode_scan(scan, pos)
                self.scans += 1
            elif code == 0xE0:
                if len(payload) >= 14 and payload[:5] == b"JFIF\x00":
                    self.jfif = True
            elif code == 0xEE:
                if len(payload) >= 12 and payload[:5] == b"Adobe":
                    self.adobe = payload[11]
            elif 0xE1 <= code <= 0xEF or code == 0xFE:
                pass
            else:
                raise IOError(f"JPEG: unknown marker 0x{code:02X}")

    def _sof(self, code: int, p: bytes) -> None:
        if self.comps:
            raise IOError("JPEG: more than one SOF marker")
        if len(p) < 6:
            raise IOError("JPEG: bad SOF segment")
        if p[0] != 8:
            raise NotImplementedError(
                f"JPEG: {p[0]}-bit sample precision (only 8-bit is decoded)")
        self.height = int.from_bytes(p[1:3], "big")
        self.width = int.from_bytes(p[3:5], "big")
        n = p[5]
        if self.height == 0:
            raise NotImplementedError(
                "JPEG: DNL marker (image height in a DNL segment)")
        if self.width == 0 or n == 0 or len(p) < 6 + 3 * n:
            raise IOError("JPEG: bad SOF segment")
        self.progressive = code == 0xC2
        for i in range(n):
            cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise IOError("JPEG: bad SOF segment")
            self.comps.append(_Component(cid, h, v, tq))

    def _check_colour(self) -> None:
        """The colour space jdapimin.c:default_decompress_parms picks, and
        the component sets that are decoded."""
        n = len(self.comps)
        if n == 4:
            kind = "YCCK" if self.adobe == 2 else "CMYK"
            raise NotImplementedError(f"JPEG: {kind} colour (4 components)")
        if n not in (1, 3):
            raise NotImplementedError(f"JPEG: {n}-component colour")
        sampling = tuple((c.h, c.v) for c in self.comps)
        if sampling not in SAMPLINGS:
            raise NotImplementedError(
                "JPEG: sampling factors "
                + " ".join(f"{h}x{v}" for h, v in sampling)
                + " (decoded: 4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0 and grey "
                "1x1)")
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * hmax))
        self.mcuy = -(-self.height // (8 * vmax))
        for c in self.comps:
            c.w = -(-self.width * c.h // hmax)
            c.hgt = -(-self.height * c.v // vmax)
            c.wb, c.hb = -(-c.w // 8), -(-c.hgt // 8)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v

    def _dht(self, p: bytes) -> None:
        pos = 0
        while pos < len(p):
            if pos + 17 > len(p):
                raise IOError("JPEG: bad DHT segment")
            tc, th = p[pos] >> 4, p[pos] & 15
            counts = list(p[pos + 1:pos + 17])
            total = sum(counts)
            if tc > 1 or th > 3 or total > 256 or pos + 17 + total > len(p):
                raise IOError("JPEG: bad DHT segment")
            self.ht[tc, th] = _Huffman(counts, p[pos + 17:pos + 17 + total])
            pos += 17 + total

    def _dqt(self, p: bytes) -> None:
        pos = 0
        while pos < len(p):
            pq, tq = p[pos] >> 4, p[pos] & 15
            size = 128 if pq else 64
            if pq > 1 or tq > 3 or pos + 1 + size > len(p):
                raise IOError("JPEG: bad DQT segment")
            if pq:
                vals = np.frombuffer(p[pos + 1:pos + 129], ">u2")
            else:
                vals = np.frombuffer(p[pos + 1:pos + 65], np.uint8)
            q = np.zeros(64, np.int64)
            # ISLOW_MULT_TYPE is a short in the SIMD build
            q[ZIGZAG] = vals.astype(np.uint16).astype(np.int16)
            self.qt[tq] = q
            pos += 1 + size

    def _sos(self, p: bytes) -> dict:
        if not self.comps:
            raise IOError("JPEG: SOS before SOF")
        if not p or len(p) < 1 + 2 * p[0] + 3:
            raise IOError("JPEG: bad SOS segment")
        n = p[0]
        if not 1 <= n <= len(self.comps):
            raise IOError("JPEG: bad SOS segment")
        comps, seen = [], set()
        for i in range(n):
            cid, tables = p[1 + 2 * i], p[2 + 2 * i]
            match = [c for c in self.comps if c.cid == cid]
            if not match or cid in seen:
                raise IOError("JPEG: bad component id in SOS")
            seen.add(cid)
            comps.append((match[0], tables >> 4, tables & 15))
        ss, se, a = p[1 + 2 * n:4 + 2 * n]
        ah, al = a >> 4, a & 15
        if not self.progressive:
            if (ss, se, ah, al) != (0, 63, 0, 0):
                raise IOError("JPEG: bad sequential scan parameters")
        else:
            bad = (se < ss or se > 63 or al > 13
                   or (ss == 0 and se != 0) or (ss > 0 and n != 1)
                   or (ah and ah != al + 1))
            if bad:
                raise IOError("JPEG: bad progressive scan parameters")
        return {"comps": comps, "ss": ss, "se": se, "ah": ah, "al": al}

    # ----------------------------------------------------- entropy data
    def _intervals(self, pos: int) -> Tuple[List[bytes], int]:
        """The scan's restart intervals, and the position of the marker
        that ends it."""
        data, n = self.data, len(self.data)
        out, start, expect = [], pos, 0
        while True:
            j = data.find(b"\xff", pos)
            if j < 0:       # the file ends without EOI: the scan ends here
                out.append(data[start:])
                return out, n
            k = j + 1
            while k < n and data[k] == 0xFF:
                k += 1
            if k >= n:
                out.append(data[start:j])
                return out, n
            code = data[k]
            if code == 0:
                pos = k + 1
                continue
            out.append(data[start:j])
            if 0xD0 <= code <= 0xD7:
                if code - 0xD0 != expect:
                    raise IOError("JPEG: restart marker out of order")
                expect = (expect + 1) & 7
                start = pos = k + 1
                continue
            return out, j

    def _decode_scan(self, scan: dict, pos: int) -> int:
        comps = scan["comps"]
        for c, _, _ in comps:
            if c.quant is None:
                if c.tq not in self.qt:
                    raise IOError(f"JPEG: quantisation table {c.tq} is not "
                                  "defined")
                c.quant = self.qt[c.tq]
                c.blocks = [[0] * 64 for _ in range(c.bw * c.bh)]
            c.coef_bits[scan["ss"]:scan["se"] + 1] = \
                [scan["al"]] * (scan["se"] + 1 - scan["ss"])
        if len(comps) == 1:
            c = comps[0][0]
            units = [[(c, r * c.bw + x)] for r in range(c.hb)
                     for x in range(c.wb)]
        else:
            units = [[(c, (my * c.v + dy) * c.bw + mx * c.h + dx)
                      for c, _, _ in comps
                      for dy in range(c.v) for dx in range(c.h)]
                     for my in range(self.mcuy) for mx in range(self.mcux)]
        intervals, end = self._intervals(pos)
        per = self.restart or len(units)
        if len(intervals) != -(-len(units) // per):
            raise IOError("JPEG: restart markers do not match the restart "
                          "interval")
        ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
        dc_first = ss == 0 and ah == 0
        tables = {}
        for c, td, ta in comps:
            need = []
            if dc_first:
                need.append((0, td))
            if se > 0:
                need.append((1, ta))
            for key in need:
                if key not in self.ht:
                    raise IOError(f"JPEG: Huffman table {key} is not "
                                  "defined")
                if key[0] == 0 and self.ht[key].max_symbol > 15:
                    raise IOError("JPEG: bad Huffman table")
            tables[c.cid] = (self.ht.get((0, td)), self.ht.get((1, ta)))
        for i, raw in enumerate(intervals):
            for c, _, _ in comps:
                c.dc_pred = 0
            br = _BitReader(raw)
            mcus = units[i * per:(i + 1) * per]
            if not self.progressive:
                _sequential(br, mcus, tables)
            elif ss == 0:
                if dc_first:
                    _dc_first(br, mcus, tables, al)
                else:
                    _dc_refine(br, mcus, al)
            elif ah == 0:
                _ac_first(br, mcus, tables, ss, se, al)
            else:
                _ac_refine(br, mcus, tables, ss, se, al)
        return end

    # ------------------------------------------------------------ output
    def output(self) -> np.ndarray:
        for c in self.comps:
            if c.blocks is None:
                raise IOError(f"JPEG: component {c.cid} has no scan")
            # jdcoefct.c smooths blocks whose first coefficients are not
            # known to full precision (smoothing_ok, SAVED_COEFS 10)
            if self.progressive and any(c.coef_bits[:10]):
                raise NotImplementedError(
                    "JPEG: progressive file whose scans leave coefficients "
                    "unrefined (libjpeg smooths those blocks)")
        planes = [_upsample(self._plane(c), c, self) for c in self.comps]
        if len(planes) == 1:
            return np.repeat(planes[0][..., None], 3, axis=-1).astype(
                np.uint8)
        if self._is_rgb():
            return np.stack(planes, axis=-1).astype(np.uint8)
        y, cb, cr = planes
        r = y + _CR_R[cr]
        g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
        b = y + _CB_B[cb]
        return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)

    def _is_rgb(self) -> bool:
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.cid for c in self.comps] == [82, 71, 66]

    def _plane(self, c: _Component) -> np.ndarray:
        """The component's samples, (downsampled height, width), int64."""
        coef = np.array(c.blocks, np.int64).reshape(c.bh, c.bw, 64)
        coef = coef[:c.hb, :c.wb] * c.quant
        px = idct_islow(coef.reshape(-1, 8, 8))
        px = px.reshape(c.hb, c.wb, 8, 8).transpose(0, 2, 1, 3)
        return px.reshape(c.hb * 8, c.wb * 8)[:c.hgt, :c.w].astype(np.int64)


def _idct_1d(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jidctint.c:jpeg_idct_islow over 8 inputs, descaled by
    ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    half = 1 << (shift - 1)
    return [(o + half) >> shift for o in out]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (natural order: [row = vertical
    frequency, column]) -> (N, 8, 8) uint8 samples, as jidctint.c computes
    them (columns into a workspace scaled by 2^PASS1_BITS, then rows)."""
    c = coef.astype(np.int64)
    ws = _idct_1d([c[:, k, :] for k in range(8)], 13 - 2)   # columns
    # [n, row, col], stored as libjpeg's int workspace
    ws = ((np.stack(ws, axis=1) + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)
    return _IDCT_LIMIT[out & 1023]


def _upsample(x: np.ndarray, c: _Component, d: _Decoder) -> np.ndarray:
    """jdsample.c: the component (h, w) to the image's (H, W)."""
    hmax = max(k.h for k in d.comps)
    vmax = max(k.v for k in d.comps)
    fh, fv = hmax // c.h, vmax // c.v
    if (fh, fv) == (1, 1):
        return x[:d.height, :d.width]
    fancy = c.w > 2
    if fh == 2 and fv == 1 and fancy:                    # h2v1_fancy
        p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((x.shape[0], 2 * c.w), np.int64)
        out[:, 0::2] = (3 * x + p[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * x + p[:, 2:] + 2) >> 2
    elif fh == 2 and fv == 2 and fancy:                  # h2v2_fancy
        pv = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        cols = np.empty((2 * x.shape[0], c.w), np.int64)
        cols[0::2] = 3 * x + pv[:-2]
        cols[1::2] = 3 * x + pv[2:]
        p = np.pad(cols, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((cols.shape[0], 2 * c.w), np.int64)
        out[:, 0::2] = (3 * cols + p[:, :-2] + 8) >> 4
        out[:, 1::2] = (3 * cols + p[:, 2:] + 7) >> 4
    elif fh == 1 and fv == 2:                            # h1v2_fancy
        pv = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * x.shape[0], c.w), np.int64)
        out[0::2] = (3 * x + pv[:-2] + 1) >> 2
        out[1::2] = (3 * x + pv[2:] + 2) >> 2
    else:                               # h2v1, h2v2 and int_upsample
        out = np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
    return out[:d.height, :d.width]


# ------------------------------------------------------ entropy decoding
def _sequential(br: _BitReader, mcus, tables) -> None:
    """jdhuff.c:decode_mcu: DC difference and AC run/size, EOB, ZRL."""
    buf, pos, zz = br.buf, br.pos, _ZZ
    for mcu in mcus:
        for c, bi in mcu:
            dc, ac = tables[c.cid]
            dcl, acl = dc.lut, ac.lut
            blk = c.blocks[bi]
            p = pos >> 3
            v = int.from_bytes(buf[p:p + 5], "big")
            off = pos & 7
            e = dcl[(v >> (24 - off)) & 0xFFFF]
            if not e:
                raise IOError("JPEG: bad Huffman code")
            ln, s = e >> 8, e & 15
            diff = 0
            if s:
                r = (v >> (40 - off - ln - s)) & ((1 << s) - 1)
                diff = r - (1 << s) + 1 if r < 1 << (s - 1) else r
            pos += ln + s
            c.dc_pred += diff
            blk[0] = ((c.dc_pred + 32768) & 0xFFFF) - 32768
            k = 1
            while k < 64:
                p = pos >> 3
                v = int.from_bytes(buf[p:p + 5], "big")
                off = pos & 7
                e = acl[(v >> (24 - off)) & 0xFFFF]
                if not e:
                    raise IOError("JPEG: bad Huffman code")
                ln, rs = e >> 8, e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise IOError("JPEG: coefficient past the block's "
                                      "end")
                    r = (v >> (40 - off - ln - s)) & ((1 << s) - 1)
                    blk[zz[k]] = r - (1 << s) + 1 if r < 1 << (s - 1) else r
                    pos += ln + s
                    k += 1
                else:
                    pos += ln
                    if rs != 0xF0:
                        break
                    k += 16
            if pos > br.nbits:
                raise IOError("JPEG: entropy-coded data ends early")
    br.pos = pos


def _decode(br: _BitReader, lut: List[int]) -> int:
    pos = br.pos
    p = pos >> 3
    v = int.from_bytes(br.buf[p:p + 3], "big")
    e = lut[(v >> (8 - (pos & 7))) & 0xFFFF]
    if not e:
        raise IOError("JPEG: bad Huffman code")
    br.pos = pos + (e >> 8)
    return e & 255


def _bits(br: _BitReader, n: int) -> int:
    if n == 0:
        return 0
    pos = br.pos
    p = pos >> 3
    v = int.from_bytes(br.buf[p:p + 4], "big")
    br.pos = pos + n
    return (v >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _bit(br: _BitReader) -> int:
    pos = br.pos
    br.pos = pos + 1
    return (br.buf[pos >> 3] >> (7 - (pos & 7))) & 1


def _dc_first(br: _BitReader, mcus, tables, al: int) -> None:
    """jdphuff.c:decode_mcu_DC_first."""
    for mcu in mcus:
        for c, bi in mcu:
            s = _decode(br, tables[c.cid][0].lut)
            diff = _extend(_bits(br, s), s) if s else 0
            c.dc_pred += diff
            c.blocks[bi][0] = _wrap16(c.dc_pred * (1 << al))
        br.check()


def _dc_refine(br: _BitReader, mcus, al: int) -> None:
    """jdphuff.c:decode_mcu_DC_refine."""
    for mcu in mcus:
        for c, bi in mcu:
            if _bit(br):
                c.blocks[bi][0] = _wrap16(c.blocks[bi][0] | (1 << al))
        br.check()


def _ac_first(br: _BitReader, mcus, tables, ss: int, se: int, al: int
              ) -> None:
    """jdphuff.c:decode_mcu_AC_first: one component, EOB runs."""
    eobrun, zz = 0, _ZZ
    for mcu in mcus:
        c, bi = mcu[0]
        if eobrun:
            eobrun -= 1
            continue
        lut, blk = tables[c.cid][1].lut, c.blocks[bi]
        k = ss
        while k <= se:
            rs = _decode(br, lut)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise IOError("JPEG: coefficient past the block's end")
                blk[zz[k]] = _wrap16(_extend(_bits(br, s), s) * (1 << al))
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = (1 << r) + _bits(br, r) - 1
                break
        br.check()


def _ac_refine(br: _BitReader, mcus, tables, ss: int, se: int, al: int
               ) -> None:
    """jdphuff.c:decode_mcu_AC_refine: new coefficients of +-2^al and a
    correction bit for each coefficient already nonzero."""
    eobrun, zz = 0, _ZZ
    p1, m1 = 1 << al, -1 << al
    for mcu in mcus:
        c, bi = mcu[0]
        lut, blk = tables[c.cid][1].lut, c.blocks[bi]
        k = ss
        if eobrun == 0:
            while k <= se:
                rs = _decode(br, lut)
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        raise IOError("JPEG: bad refinement coefficient")
                    s = p1 if _bit(br) else m1
                elif r != 15:
                    eobrun = (1 << r) + _bits(br, r)
                    break
                while k <= se:
                    pos = zz[k]
                    if blk[pos]:
                        if _bit(br) and not blk[pos] & p1:
                            blk[pos] = _wrap16(
                                blk[pos] + (p1 if blk[pos] >= 0 else m1))
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > 63:
                        raise IOError("JPEG: coefficient past the block's "
                                      "end")
                    blk[zz[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                pos = zz[k]
                if blk[pos] and _bit(br) and not blk[pos] & p1:
                    blk[pos] = _wrap16(blk[pos] + (p1 if blk[pos] >= 0
                                                   else m1))
                k += 1
            eobrun -= 1
        br.check()


# ------------------------------------------------------------ public API
def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3), in numpy and Python."""
    d = _Decoder(data)
    d.run()
    return d.output()


# the compiled decoder's error codes: those from REFUSED_FROM up name a
# variant that is not decoded (NotImplementedError), the others a
# malformed file (IOError)
REFUSED_FROM = 100
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:    # the batch decode's threads ask at once
        if _lib is not None:
            return _lib
        from splatformer_tpu_torch.kernels import build
        lib = build.load("jpeg_decode")
        lib.sf_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
        lib.sf_jpeg_info.restype = ctypes.c_int
        lib.sf_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int]
        lib.sf_jpeg_decode.restype = ctypes.c_int
        lib.sf_jpeg_message.argtypes = [ctypes.c_int]
        lib.sf_jpeg_message.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _raise(lib: ctypes.CDLL, rc: int) -> None:
    msg = "JPEG: " + lib.sf_jpeg_message(rc).decode()
    raise (NotImplementedError if rc >= REFUSED_FROM else IOError)(msg)


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(width, height) through the compiled decoder's header parser."""
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.sf_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc:
        _raise(lib, rc)
    return w.value, h.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) through csrc/jpeg_decode.cpp."""
    lib = _load()
    w, h = jpeg_size(data)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.sf_jpeg_decode(data, len(data), out.ctypes.data, w, h)
    if rc:
        _raise(lib, rc)
    return out
