"""A small baseline JPEG writer for the tests (not collected).

It writes what Pillow cannot: any sampling factors (4:1:1, 4:4:0), one
scan a component (a non-interleaved sequential file), restart intervals.
The decoders are then held against libjpeg-turbo on those files. Its
arithmetic need not match any encoder's: a float DCT, rounding
quantisation, and flat Huffman tables (every DC category at 5 bits, every
AC symbol of the 162 at 8 bits) make a valid file.
"""
import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DC_SYMBOLS = list(range(16))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
_DC_CODES = {s: (i, 5) for i, s in enumerate(_DC_SYMBOLS)}
_AC_CODES = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}
_U = np.arange(8)
_DCT = np.where(_U[:, None] == 0, np.sqrt(0.125), 0.5) * np.cos(
    (2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16)


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(tc: int, symbols, length: int) -> bytes:
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return bytes([tc << 4]) + bytes(counts) + bytes(symbols)


def encode(img: np.ndarray, sampling, quant: int = 8, restart: int = 0,
           interleaved: bool = True) -> bytes:
    """uint8 (H, W, 3) RGB -> a JFIF YCbCr baseline JPEG with per-component
    sampling factors ``sampling`` [(h, v)] x 3, a flat quantiser
    ``quant``, a restart marker every ``restart`` MCUs (0: none), and all
    components in one scan or one scan each."""
    h, w = img.shape[:2]
    rgb = img.astype(np.float64)
    ycc = np.stack([
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
        128 - 0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1]
        + 0.5 * rgb[..., 2],
        128 + 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1]
        - 0.081312 * rgb[..., 2]], axis=-1)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for ci, (ch, cv) in enumerate(sampling):
        fx, fy = hmax // ch, vmax // cv
        cw, chh = -(-w * ch // hmax), -(-h * cv // vmax)
        pad = np.pad(ycc[..., ci], ((0, chh * fy - h), (0, cw * fx - w)),
                     mode="edge")
        plane = pad.reshape(chh, fy, cw, fx).mean(axis=(1, 3))
        bw, bh = mcux * ch, mcuy * cv
        plane = np.pad(plane, ((0, bh * 8 - chh), (0, bw * 8 - cw)),
                       mode="edge")
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
        q = np.rint(coef / quant).astype(np.int64).reshape(bh, bw, 64)
        comps.append({"id": ci + 1, "h": ch, "v": cv, "q": q[..., _ZIGZAG],
                      "wb": -(-cw // 8), "hb": -(-chh // 8)})

    def units(scan):
        if len(scan) == 1:
            c = scan[0]
            return [[(c, r, x)] for r in range(c["hb"])
                    for x in range(c["wb"])]
        return [[(c, my * c["v"] + dy, mx * c["h"] + dx) for c in scan
                 for dy in range(c["v"]) for dx in range(c["h"])]
                for my in range(mcuy) for mx in range(mcux)]

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, bytes([0]) + bytes([quant] * 64))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([len(comps)])
    for c in comps:
        sof += bytes([c["id"], (c["h"] << 4) | c["v"], 0])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, _dht(0, _DC_SYMBOLS, 5) + _dht(1, _AC_SYMBOLS, 8))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    scans = [comps] if interleaved else [[c] for c in comps]
    for scan in scans:
        sos = bytes([len(scan)])
        for c in scan:
            sos += bytes([c["id"], 0x00])
        out += _segment(0xDA, sos + bytes([0, 63, 0]))
        bits, pred = _Bits(), {c["id"]: 0 for c in scan}
        for i, mcu in enumerate(units(scan)):
            if restart and i and i % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                bits, pred = _Bits(), {c["id"]: 0 for c in scan}
            for c, r, x in mcu:
                blk = c["q"][r, x]
                s, v = _category(int(blk[0]) - pred[c["id"]])
                pred[c["id"]] = int(blk[0])
                bits.put(*_DC_CODES[s])
                bits.put(v, s)
                run = 0
                for k in range(1, 64):
                    a = int(blk[k])
                    if a == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*_AC_CODES[0xF0])
                        run -= 16
                    s, v = _category(a)
                    bits.put(*_AC_CODES[(run << 4) | s])
                    bits.put(v, s)
                    run = 0
                if run:
                    bits.put(*_AC_CODES[0x00])
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")
