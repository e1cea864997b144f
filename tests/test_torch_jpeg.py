"""The port's JPEG decoders (splatformer_tpu_torch/data/jpeg.py: the numpy
plain version and the compiled csrc/jpeg_decode.cpp) against the JAX
package's native_io, which decodes through libjpeg-turbo (native/io.cc):
bit for bit on a grid of Pillow-written files (sampling sets, sizes,
qualities, optimised tables, restart markers, RGB, progressive, 16-bit
tables; smooth, saturated, checkerboard and noise content) and on the
committed fixtures of tests/data/jpeg/ (manifest.json, written by
tests/jpeg_fixture_gen.py); the compiled decoder equal to the plain one;
the threaded decode_batch equal to serial decodes; every refused variant
by name. Of the JAX package only native_io is imported, so nothing is
compiled by JAX. A file that libjpeg refuses (CMYK, a rewritten header)
is never handed to native_io: libjpeg's error exit ends the process.

Pillow writes no 4:1:1 (its "4:1:1" is 4:2:0), no 4:4:0 and no sequential
file of one scan a component; tests/jpeg_encoder.py writes those.
"""
import hashlib
import io
import itertools
import json
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from splatformer_tpu.data import dataset as jds  # noqa: E402
from splatformer_tpu.data import native_io  # noqa: E402
from splatformer_tpu_torch.data import dataset as tds  # noqa: E402
from splatformer_tpu_torch.data import image_io, jpeg  # noqa: E402
from splatformer_tpu_torch.kernels import build  # noqa: E402

from jpeg_encoder import encode  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (16, 16), (17, 33), (61, 83))
CONTENTS = ("smooth", "saturated", "checker", "noise")
QUALITIES = (1, 50, 90, 100)
# variant -> (Pillow mode, save options, qualities)
VARIANTS = {
    "444": ("RGB", {"subsampling": 0}, QUALITIES),
    "422": ("RGB", {"subsampling": 1}, QUALITIES),
    "420": ("RGB", {"subsampling": 2}, QUALITIES),
    "grey": ("L", {}, QUALITIES),
    "optimize": ("RGB", {"optimize": True}, (75,)),
    "restart_blocks_1": ("RGB", {"restart_marker_blocks": 1}, (75,)),
    "restart_blocks_3": ("RGB", {"restart_marker_blocks": 3}, (75,)),
    "restart_rows": ("RGB", {"restart_marker_rows": 1}, (75,)),
    "keep_rgb": ("RGB", {"keep_rgb": True}, (75, 100)),
    "table16": ("RGB", {"qtables": [[300] * 64, [1000] * 64]}, (None,)),
    "progressive_444": ("RGB", {"progressive": True, "subsampling": 0},
                        (75,)),
    "progressive_422": ("RGB", {"progressive": True, "subsampling": 1},
                        (75,)),
    "progressive_420": ("RGB", {"progressive": True, "subsampling": 2},
                        (75, 100)),
    "progressive_grey": ("L", {"progressive": True}, (75,)),
    "progressive_restart": ("RGB", {"progressive": True,
                                    "restart_marker_blocks": 2}, (75,)),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _content(kind, h, w, rng):
    y, x = np.mgrid[0:h, 0:w]
    if kind == "smooth":
        img = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                        (x + y) * 127.0 / max(w + h - 2, 1)], axis=-1)
        return img.astype(np.uint8)
    if kind == "saturated":
        return rng.integers(0, 2, (h, w, 3), dtype=np.uint8) * np.uint8(255)
    if kind == "checker":
        c = ((x + y) % 2 * 255).astype(np.uint8)
        return np.stack([c, 255 - c, c], axis=-1)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _save(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img if mode == "RGB" else img[..., 0], mode).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


@lru_cache(maxsize=None)
def _grid(variant):
    """(label, JPEG bytes) of one variant over sizes, contents, qualities,
    from a seed of its own."""
    mode, opts, qualities = VARIANTS[variant]
    rng = np.random.default_rng(sorted(VARIANTS).index(variant))
    out = []
    for (h, w), kind, q in itertools.product(SIZES, CONTENTS, qualities):
        kw = dict(opts) if q is None else dict(opts, quality=q)
        out.append((f"{variant} {h}x{w} {kind} q{q}",
                    _save(_content(kind, h, w, rng), mode, **kw)))
    return tuple(out)


def _native(tmp_path, data, name="x.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return native_io.decode_image(path)


def _float(u8):
    return u8.astype(np.float32) / np.float32(255.0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_decoder_matches_libjpeg_turbo(variant, tmp_path):
    for label, data in _grid(variant):
        got = _float(jpeg.decode_jpeg_plain(data))
        want = _native(tmp_path, data)
        assert got.shape == want.shape, label
        assert np.array_equal(got, want), label


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compiled_decoder_matches_plain(variant):
    for label, data in _grid(variant):
        plain = jpeg.decode_jpeg_plain(data)
        assert np.array_equal(jpeg.decode_jpeg(data), plain), label
        assert jpeg.jpeg_size(data) == plain.shape[1::-1], label


# variant -> (sampling factors, one scan a component, restart interval)
WRITTEN = {"411": ([(4, 1), (1, 1), (1, 1)], False, 0),
           "440": ([(1, 2), (1, 1), (1, 1)], False, 0),
           "411_scans_restart": ([(4, 1), (1, 1), (1, 1)], True, 3),
           "440_restart": ([(1, 2), (1, 1), (1, 1)], False, 2),
           "420_scans": ([(2, 2), (1, 1), (1, 1)], True, 0),
           "444_scans_restart": ([(1, 1), (1, 1), (1, 1)], True, 5)}


@pytest.mark.parametrize("variant", sorted(WRITTEN))
def test_written_files_match_libjpeg_turbo(variant, tmp_path):
    """Files Pillow cannot write (tests/jpeg_encoder.py): both decoders
    equal libjpeg-turbo's decode bit for bit."""
    sampling, scans, restart = WRITTEN[variant]
    rng = np.random.default_rng(100 + sorted(WRITTEN).index(variant))
    for (h, w), kind, quant in itertools.product(SIZES, CONTENTS, (2, 12)):
        data = encode(_content(kind, h, w, rng), sampling, quant=quant,
                      restart=restart, interleaved=not scans)
        label = f"{variant} {h}x{w} {kind} q{quant}"
        plain = jpeg.decode_jpeg_plain(data)
        assert np.array_equal(_float(plain), _native(tmp_path, data)), label
        assert np.array_equal(jpeg.decode_jpeg(data), plain), label


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _sha(u8):
    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def test_committed_fixtures_against_manifest_and_native_io():
    """Each decoded fixture: native_io's, the plain and the compiled
    decoders' uint8 images all hash to the manifest's SHA-256."""
    manifest = _manifest()
    decoded = [k for k, v in manifest.items() if "sha256" in v]
    assert len(decoded) >= 30 and any(k.startswith("capture/") for k in decoded)
    for rel in decoded:
        path = os.path.join(FIXTURES, rel)
        with open(path, "rb") as f:
            data = f.read()
        entry = manifest[rel]
        native = native_io.decode_image(path)
        assert list(native.shape) == entry["shape"], rel
        assert _sha(np.rint(native * 255).astype(np.uint8)) == \
            entry["sha256"], rel
        assert _sha(jpeg.decode_jpeg(data)) == entry["sha256"], rel
        assert _sha(jpeg.decode_jpeg_plain(data)) == entry["sha256"], rel
        assert np.array_equal(image_io.decode_image(path), native), rel


def test_refused_variants_raise_by_name():
    """Every refused fixture raises NotImplementedError naming the variant
    in both decoders and through image_io (never through native_io)."""
    manifest = _manifest()
    refused = {k: v for k, v in manifest.items() if "raises" in v}
    assert {v["match"] for v in refused.values()} >= {
        "CMYK", "YCCK", "arithmetic coding", "lossless", "precision",
        "sampling"}
    for rel, entry in refused.items():
        assert entry["raises"] == "NotImplementedError"
        path = os.path.join(FIXTURES, rel)
        with open(path, "rb") as f:
            data = f.read()
        for fn in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain, jpeg.jpeg_size):
            with pytest.raises(NotImplementedError, match=entry["match"]):
                fn(data)
        with pytest.raises(NotImplementedError, match=entry["match"]):
            image_io.decode_image(path)


def _dht(counts, tc_th=0x00):
    """A DHT segment of one table: 16 counts, zero symbols."""
    body = bytes([tc_th]) + bytes(counts) + bytes(sum(counts))
    return b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body


def test_corrupt_data_raises_ioerror():
    """Truncated entropy data, a bad restart marker, a missing SOI, an
    over-subscribed Huffman table, a Huffman table selector past 3 and a
    scan of no components are IOError in both decoders (libjpeg-turbo would
    warn and fill zeros, or stop)."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    data = _save(img, "RGB", quality=90)
    rst = _save(img, "RGB", quality=90, restart_marker_blocks=2)
    i = rst.index(b"\xff\xd0")
    sos = data.index(b"\xff\xda")
    sos_end = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")

    def selector(t):    # the first scan component's table byte set to t
        return data[:sos + 6] + bytes([t]) + data[sos + 7:]

    cases = {"truncated": data[:len(data) // 2],
             "no_eoi_short": data[:-200],
             "restart_order": rst[:i + 1] + b"\xd3" + rst[i + 2:],
             "no_soi": data[2:],
             "dht_3_codes_of_1_bit": data[:2] + _dht([3] + [0] * 15)
             + data[2:],
             "dht_200_codes_of_1_bit": data[:2] + _dht([200] + [0] * 15)
             + data[2:],
             "dht_full_length_2": data[:2] + _dht([0, 4] + [0] * 14, 0x11)
             + data[2:],
             "dc_selector_5": selector(0x50),
             "ac_selector_9": selector(0x09),
             "sos_no_components": data[:sos] + b"\xff\xda\x00\x06\x00\x00"
             b"\x3f\x00" + data[sos_end:]}
    for name, bad in cases.items():
        for fn in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain):
            with pytest.raises(IOError):
                fn(bad)
    # a file whose EOI alone is missing decodes whole, as in libjpeg
    assert np.array_equal(jpeg.decode_jpeg(data[:-2]),
                          jpeg.decode_jpeg_plain(data))


def test_failed_allocation_raises_ioerror():
    """A header whose size the decoder cannot allocate (16384^2, 4:4:4)
    raises IOError in a process whose address space is capped, instead of
    letting std::bad_alloc end the process. Nothing is touched: the cap
    makes the allocation fail before a page is written."""
    data = _save(np.zeros((8, 8, 3), np.uint8), "RGB", subsampling=0)
    sof = data.index(b"\xff\xc0")
    big = data[:sof + 5] + (16384).to_bytes(2, "big") * 2 + data[sof + 9:]
    code = (
        "import re, resource, sys\n"
        "from splatformer_tpu_torch.data import jpeg\n"
        "jpeg._load()\n"
        "kb = int(re.search(r'VmSize:\\s+(\\d+)', "
        "open('/proc/self/status').read()).group(1))\n"
        "cap = kb * 1024 + (1200 << 20)\n"
        "resource.setrlimit(resource.RLIMIT_AS, (cap, cap))\n"
        "try:\n"
        "    jpeg.decode_jpeg(sys.stdin.buffer.read())\n"
        "except IOError as e:\n"
        "    print(e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], input=big, cwd=root,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"out of memory" in proc.stdout, proc.stdout


def test_decode_batch_equals_serial(tmp_path):
    """decode_batch of 24 same-shaped files (JPEG of several kinds and PNG)
    equals the serial decodes and native_io.decode_batch; images of two
    sizes fail as one batch and read_images falls back per image, equal to
    the JAX package's read_images."""
    rng = np.random.default_rng(22)
    paths = []
    for i in range(24):
        img = _content(CONTENTS[i % 4], 40, 56, rng)
        path = str(tmp_path / f"v{i:02d}.{'png' if i % 6 == 5 else 'jpg'}")
        if path.endswith(".png"):
            Image.fromarray(img).save(path)
        else:
            with open(path, "wb") as f:
                f.write(_save(img, "RGB", quality=70 + i,
                              progressive=i % 3 == 0))
        paths.append(path)
    batch = image_io.decode_batch(paths)
    serial = np.stack([image_io.decode_image(p) for p in paths])
    assert batch.dtype == np.float32 and np.array_equal(batch, serial)
    assert np.array_equal(batch, native_io.decode_batch(paths))
    bg = np.array([0.1, 0.7, 0.3], np.float32)
    for got, want in zip(tds.read_images(paths, bg),
                         jds.read_images(paths, bg)):
        assert np.array_equal(got, want)
    odd = str(tmp_path / "odd.jpg")
    with open(odd, "wb") as f:
        f.write(_save(_content("noise", 17, 33, rng), "RGB"))
    mixed = paths[:3] + [odd]
    with pytest.raises(IOError, match="shape"):
        image_io.decode_batch(mixed)
    got, want = tds.read_images(mixed, bg), jds.read_images(mixed, bg)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_jpeg_named_png_and_image_info(tmp_path):
    """The port reads the signature: a JPEG named *.png decodes (the JAX
    package, which goes by the name, fails on it) to what native_io gives
    for the same bytes named *.jpg; image_info agrees with native_io's."""
    rng = np.random.default_rng(23)
    data = _save(_content("noise", 19, 21, rng), "RGB", quality=80)
    as_png = str(tmp_path / "photo.png")
    with open(as_png, "wb") as f:
        f.write(data)
    assert np.array_equal(image_io.decode_image(as_png),
                          _native(tmp_path, data))
    assert image_io.image_info(as_png) == (21, 19, 3)
    for name, im in (("rgba.png", Image.fromarray(
            rng.integers(0, 256, (5, 6, 4), dtype=np.uint8), "RGBA")),
            ("grey.png", Image.fromarray(
                rng.integers(0, 256, (5, 6), dtype=np.uint8), "L"))):
        im.save(str(tmp_path / name))
        assert image_io.image_info(str(tmp_path / name)) == \
            native_io.image_info(str(tmp_path / name))
    jpg = str(tmp_path / "x.jpg")
    assert image_io.image_info(jpg) == native_io.image_info(jpg)


def test_failed_build_raises_without_fallback(monkeypatch):
    """A compiler error raises with the compiler's output; nothing falls
    back to the plain version."""
    monkeypatch.setattr(build, "HOST_FLAGS",
                        build.HOST_FLAGS + ("--no-such-flag",))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(jpeg, "_lib", None)
    data = _save(np.zeros((8, 8, 3), np.uint8), "RGB")
    with pytest.raises(RuntimeError, match="no-such-flag"):
        jpeg.decode_jpeg(data)
