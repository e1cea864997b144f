"""PNG decoding in numpy and zlib: the port's counterpart of
splatformer_tpu/data/native_io.py, whose libpng/libjpeg decoder
(native/io.cc) cannot be built on machines without png.h and jpeglib.h.

``decode_image`` returns what native/io.cc returns for a PNG: float32
(H, W, C) in [0, 1], each 8-bit sample divided by 255; 16-bit samples keep
their high byte; grey becomes RGB, grey + alpha RGBA; a palette becomes
RGB, or RGBA when the file has a tRNS chunk; low-bit grey expands to 8 bits
(x 255 / (2^depth - 1)); a tRNS colour key becomes an alpha channel. All
five row filters are undone. Interlaced PNGs and JPEGs are refused by name
(ROADMAP.md queue 1 item 3).
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel by colour type: grey, RGB, palette, grey + alpha, RGBA
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class _Png(NamedTuple):
    width: int
    height: int
    depth: int
    color: int
    palette: bytes
    trns: bytes
    idat: bytes


def _read_png(path: str) -> _Png:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        if data[:2] == b"\xff\xd8":
            raise NotImplementedError(
                f"{path}: JPEG decoding is not ported (no libjpeg on the "
                "card's machine; ROADMAP.md queue 1 item 3)")
        raise IOError(f"cannot decode {path}: not a PNG")
    pos, ihdr, palette, trns, idat = len(_SIGNATURE), None, b"", b"", []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise IOError(f"cannot decode {path}: bad {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise IOError(f"cannot decode {path}: no IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in _SAMPLES:
        raise IOError(f"cannot decode {path}: colour type {color}")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    return _Png(w, h, depth, color, palette, trns, b"".join(idat))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + row bytes) filtered rows -> (H, row bytes) uint8 samples.

    A byte depends on the byte ``bpp`` to its left and on the row above,
    so the units of ``bpp`` bytes are undone along anti-diagonals: every
    unit on one diagonal has both neighbours done, whatever its row's
    filter."""
    ftype = rows[:, 0]
    raw = rows[:, 1:]
    if not ftype.any():
        return raw
    if ftype.max() > 4:
        raise IOError(f"PNG row filter {int(ftype.max())}")
    h, n = raw.shape
    u = n // bpp
    x = raw.reshape(h, u, bpp).astype(np.int32)
    # out[r + 1, i + 1] is unit i of row r; row 0 and column 0 are zeros
    out = np.zeros((h + 1, u + 1, bpp), np.int32)
    for t in range(h + u - 1):
        r = np.arange(max(0, t - u + 1), min(h - 1, t) + 1)
        i = t - r
        a, b, c = out[r + 1, i], out[r, i + 1], out[r, i]
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, i + 1] = (x[r, i] + pred) & 255
    return out[1:, 1:].reshape(h, n).astype(np.uint8)


def _unpack_bits(samples: np.ndarray, depth: int, count: int) -> np.ndarray:
    """(H, row bytes) packed sub-byte samples -> (H, count) values."""
    if depth == 8:
        return samples[:, :count]
    bits = np.unpackbits(samples, axis=1)
    bits = bits[:, :count * depth].reshape(samples.shape[0], count, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2).astype(np.uint8)


def decode_image(path: str) -> np.ndarray:
    """-> float32 (H, W, C) in [0, 1], C 3 or 4."""
    png = _read_png(path)
    w, h, depth, color = png.width, png.height, png.depth, png.color
    nsamp = _SAMPLES[color]
    bits = nsamp * depth
    rows = np.frombuffer(zlib.decompress(png.idat), np.uint8)
    rows = rows[:h * (1 + (w * bits + 7) // 8)].reshape(h, -1)
    data = _unfilter(rows, max(1, bits // 8))
    if depth == 16:
        wide = data.reshape(h, w * nsamp, 2)
        key = wide[..., 0].astype(np.uint16) << 8 | wide[..., 1]
        vals = wide[..., 0]
    else:
        vals = _unpack_bits(data, depth, w * nsamp)
        key = vals
    vals = vals.reshape(h, w, nsamp)
    key = key.reshape(h, w, nsamp)
    if color == 3:
        pal = np.frombuffer(png.palette, np.uint8).reshape(-1, 3)
        idx = vals[..., 0]
        img = pal[idx]
        if png.trns:
            alpha = np.full(len(pal), 255, np.uint8)
            alpha[:len(png.trns)] = np.frombuffer(png.trns, np.uint8)
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
    else:
        img = vals
        if color == 0 and depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        if png.trns and color in (0, 2):
            trans = np.array(struct.unpack(f">{nsamp}H", png.trns))
            alpha = np.where(np.all(key == trans, axis=-1), 0, 255)
            img = np.concatenate([img, alpha[..., None].astype(np.uint8)],
                                 axis=-1)
        if color in (0, 4):
            img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1),
                                  img[..., 1:]], axis=-1)
    return img.astype(np.float32) / np.float32(255.0)
