"""Time the port's JPEG decoders beside the JAX package's libjpeg-turbo
(native_io) on this machine's CPU (not a test; needs Pillow and
native/libsplatformer_io.so, so it runs where the JAX package's native
library is built, not on the card's machine).

    python tests/jpeg_decode_timing.py      # from the root of a checkout

Prints one JSON line: on a seeded 1920x1080 frame (ramps and noise,
Pillow quality 90, 4:2:0, baseline and progressive) the median ms of
native_io.decode_image, of the compiled decoder alone and with the float
conversion (image_io.decode_image), and one run of the plain decoder; on
the committed capture (tests/data/jpeg/capture, 12 views at 512^2) ms a
megapixel of both decoders, serial image_io.decode_image against
image_io.decode_batch, and native_io's own batch beside them.
"""
import glob
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
from PIL import Image

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
ROUNDS = 7


def median_ms(fn):
    fn()
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def main() -> int:
    from splatformer_tpu.data import native_io
    from splatformer_tpu_torch.data import image_io, jpeg

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:1080, 0:1920]
    frame = np.stack([x * 255 / 1919, y * 255 / 1079, (x + y) * 127 / 2998],
                     axis=-1)
    frame = np.clip(frame + rng.normal(0, 12, frame.shape), 0, 255)
    frame = frame.astype(np.uint8)
    out = {"cpu_cores": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("baseline", {}), ("progressive",
                                            {"progressive": True})):
            buf = io.BytesIO()
            Image.fromarray(frame).save(buf, "JPEG", quality=90,
                                        subsampling=2, **kw)
            data = buf.getvalue()
            path = os.path.join(tmp, f"{name}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            jpeg.decode_jpeg_plain(data)
            plain_ms = 1e3 * (time.perf_counter() - t0)
            out[f"1080p_{name}"] = {
                "bytes": len(data),
                "native_io_ms": median_ms(lambda: native_io.decode_image(path)),
                "compiled_ms": median_ms(lambda: jpeg.decode_jpeg(data)),
                "compiled_float_ms": median_ms(
                    lambda: image_io.decode_image(path)),
                "plain_ms": plain_ms}
    paths = sorted(glob.glob(os.path.join(
        ROOT, "tests", "data", "jpeg", "capture", "images", "*.jpg")))
    blobs = [open(p, "rb").read() for p in paths]
    mpix = len(paths) * 512 * 512 / 1e6
    t0 = time.perf_counter()
    for b in blobs:
        jpeg.decode_jpeg_plain(b)
    plain_s = time.perf_counter() - t0
    serial = median_ms(lambda: [image_io.decode_image(p) for p in paths])
    batch = median_ms(lambda: image_io.decode_batch(paths))
    out["capture"] = {
        "views": len(paths),
        "plain_ms_per_mpix": 1e3 * plain_s / mpix,
        "compiled_ms_per_mpix": median_ms(
            lambda: [jpeg.decode_jpeg(b) for b in blobs]) / mpix,
        "serial_decode_image_ms": serial, "decode_batch_ms": batch,
        "decode_batch_speedup": serial / batch,
        "native_io_serial_ms": median_ms(
            lambda: [native_io.decode_image(p) for p in paths]),
        "native_io_batch_ms": median_ms(
            lambda: native_io.decode_batch(paths))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
