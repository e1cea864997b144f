"""Write the committed JPEG fixtures under tests/data/jpeg/ (not a test).

    python tests/jpeg_fixture_gen.py      # from the root of a checkout

* ``capture/``: a COLMAP capture, 12 views at 512x512 of a procedural
  ground-truth scene (data/procgen.py, seed 7, 32,768 Gaussians): 10
  training views on two low azimuth rings and 2 held-out views from above
  (``test_*``, as the data factory names them), rendered on the CPU by the
  port and written by Pillow at 4:2:0, quality 90: view 3 with a restart
  marker every MCU row, view 8 every 5 MCUs, view 5 progressive;
  ``sparse/0/*.bin`` by data/colmap.py with 1,024 of the scene's points as
  the SfM cloud;
* ``variety/``: small files of every sampling set Pillow writes, grey,
  RGB (``keep_rgb``), optimised tables, quality 1 and 100, 16-bit
  quantisation tables (SOF1), restart markers by blocks and by rows,
  progressive at 4:2:0 and grey, 1x1 and 17x33; 4:1:1, 4:4:0 and a
  sequential file of one scan a component with restart markers, written
  by tests/jpeg_encoder.py; and files the decoders refuse: CMYK from
  Pillow, and Pillow files whose headers are rewritten to YCCK,
  arithmetic coding, lossless, 12-bit samples and 3x1 sampling;
* ``manifest.json``: for each file its shape and the SHA-256 of the uint8
  image that the JAX package's native_io (libjpeg-turbo) decodes from it,
  or the exception a refused file raises and a word its message holds.
  No refused file is handed to native_io: libjpeg's error exit would end
  this process.

Needs Pillow, the JAX package's native/libsplatformer_io.so and the port.
"""
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

from jpeg_encoder import encode

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
CAPTURE_HW = 512
SH_C0 = 0.28209479177387814


def pillow_jpeg(img: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def native_uint8(path: str) -> np.ndarray:
    """libjpeg-turbo's uint8 decode, recovered from native_io's x / 255."""
    from splatformer_tpu.data import native_io
    f = native_io.decode_image(path)
    u8 = np.rint(f * 255.0).astype(np.uint8)
    assert np.array_equal(u8.astype(np.float32) / np.float32(255.0), f)
    return u8


def sha256(u8: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def content(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth ramps with seeded noise and a saturated square."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                    (x + y) * 127.0 / max(w + h - 2, 1)], axis=-1)
    img = img + rng.normal(0.0, 24.0, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = (255, 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8)


def marker_offset(data: bytes, code: int) -> int:
    """The offset of the first marker ``code`` in the header segments."""
    pos = 2
    while data[pos + 1] != code:
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return pos


def patched(data: bytes, offset: int, value: int) -> bytes:
    return data[:offset] + bytes([value]) + data[offset + 1:]


def variety(rng: np.random.Generator) -> dict:
    """name -> (bytes, None) for decoded files, (bytes, (exception, word))
    for refused ones."""
    a = content(rng, 61, 64)
    out = {
        "s444.jpg": pillow_jpeg(a, subsampling=0, quality=85),
        "s422.jpg": pillow_jpeg(a, subsampling=1, quality=85),
        "s420.jpg": pillow_jpeg(a, subsampling=2, quality=85),
        "grey.jpg": pillow_jpeg(a[..., 0], "L", quality=85),
        "keep_rgb.jpg": pillow_jpeg(a, keep_rgb=True, quality=85),
        "optimize.jpg": pillow_jpeg(a, optimize=True, quality=85),
        "q1.jpg": pillow_jpeg(a, quality=1),
        "q100.jpg": pillow_jpeg(a, quality=100, subsampling=0),
        "qt16.jpg": pillow_jpeg(a, qtables=[[300] * 64, [1000] * 64]),
        "rst_blocks.jpg": pillow_jpeg(a, restart_marker_blocks=3),
        "rst_rows.jpg": pillow_jpeg(a, restart_marker_rows=1),
        "prog420.jpg": pillow_jpeg(a, progressive=True, subsampling=2),
        "prog_grey.jpg": pillow_jpeg(a[..., 1], "L", progressive=True),
        "tiny_1x1.jpg": pillow_jpeg(a[:1, :1]),
        "odd_17x33.jpg": pillow_jpeg(content(rng, 17, 33), subsampling=2),
    }
    b = content(rng, 45, 70)
    out.update({
        "s411.jpg": encode(b, [(4, 1), (1, 1), (1, 1)], quant=6),
        "s440.jpg": encode(b, [(1, 2), (1, 1), (1, 1)], quant=6),
        "scans_420.jpg": encode(b, [(2, 2), (1, 1), (1, 1)], quant=6,
                                restart=5, interleaved=False)})
    decoded = {k: (v, None) for k, v in out.items()}
    cmyk = pillow_jpeg(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8),
                       "CMYK")
    base = out["s420.jpg"]
    sof = marker_offset(base, 0xC0)
    adobe = marker_offset(cmyk, 0xEE)
    refused = {
        "cmyk.jpg": (cmyk, "CMYK"),
        "ycck.jpg": (patched(cmyk, adobe + 4 + 11, 2), "YCCK"),
        "arith.jpg": (patched(base, sof + 1, 0xC9), "arithmetic coding"),
        "lossless.jpg": (patched(base, sof + 1, 0xC3), "lossless"),
        "p12.jpg": (patched(base, sof + 4, 12), "precision"),
        "s311.jpg": (patched(base, sof + 11, 0x31), "sampling"),
    }
    decoded.update({k: (v, ("NotImplementedError", word))
                    for k, (v, word) in refused.items()})
    return decoded


def capture(root: str) -> dict:
    """The 12-view capture; returns name -> bytes of its images."""
    import torch

    from splatformer_tpu_torch.data import colmap as cm
    from splatformer_tpu_torch.data.procgen import make_gt_scene, ring_cameras
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    hw = CAPTURE_HW
    gt = make_gt_scene(7, n_gauss=32768, device="cpu")
    rings = (ring_cameras([15.0, 30.0], 5, hw, hw, az_jitter=0.15, seed=7,
                          device="cpu"),
             ring_cameras([75.0], 2, hw, hw, az_jitter=0.3, seed=8,
                          device="cpu"))
    imgs, c2w = [], []
    for cams in rings:
        with torch.no_grad():
            rgb = render_images(gt, cams, torch.zeros(3),
                                RasterizeConfig(max_intersects=2 ** 21))[0]
        imgs.append((np.clip(rgb.numpy(), 0, 1) * 255).astype(np.uint8))
        c2w.append(cams.c2w.numpy())
    imgs, c2w = np.concatenate(imgs), np.concatenate(c2w)
    n_train = len(imgs) - 2

    def colmap_pose(c2w_gl: np.ndarray):
        c2w = np.eye(4)
        c2w[:3, :4] = c2w_gl
        c2w[0:3, 1:3] *= -1  # OpenGL -> OpenCV
        w2c = np.linalg.inv(c2w)
        return cm.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]

    cam = rings[0]
    cameras = {1: cm.ColmapCamera(1, "PINHOLE", hw, hw, np.array(
        [float(cam.fx[0]), float(cam.fy[0]), float(cam.cx[0]),
         float(cam.cy[0])]))}
    options = {3: {"restart_marker_rows": 1},
               5: {"progressive": True},
               8: {"restart_marker_blocks": 5}}
    images, files = {}, {}
    empty, empty_ids = np.zeros((0, 2)), np.zeros((0,), np.int64)
    for i in range(imgs.shape[0]):
        name = (f"frame_{i:05d}.jpg" if i < n_train
                else f"test_{i - n_train:02d}.jpg")
        q, t = colmap_pose(c2w[i])
        images[i + 1] = cm.ColmapImage(i + 1, q, t, 1, name, empty,
                                       empty_ids)
        files[name] = pillow_jpeg(imgs[i], quality=90, subsampling=2,
                                  **options.get(i, {}))
    means = gt.means.numpy()
    cols = gt.features_dc.numpy() * SH_C0 + 0.5
    sub = np.linspace(0, len(means) - 1, 1024, dtype=int)
    points = {j + 1: cm.ColmapPoint3D(
        j + 1, means[p].astype(np.float64),
        (np.clip(cols[p], 0, 1) * 255).astype(np.uint8), 0.0,
        np.zeros((0,), np.int64), np.zeros((0,), np.int64))
        for j, p in enumerate(sub)}
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    cm.write_model(cameras, images, points, sparse, ext=".bin")
    return files


def main() -> int:
    rng = np.random.default_rng(13)
    manifest = {}
    entries = {f"variety/{k}": v for k, v in variety(rng).items()}
    cap = capture(os.path.join(OUT, "capture"))
    entries.update({f"capture/images/{k}": (v, None)
                    for k, v in cap.items()})
    for rel, (data, refusal) in sorted(entries.items()):
        path = os.path.join(OUT, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        if refusal:
            manifest[rel] = {"raises": refusal[0], "match": refusal[1]}
        else:
            u8 = native_uint8(path)
            manifest[rel] = {"shape": list(u8.shape), "sha256": sha256(u8)}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(OUT) for n in names)
    print(f"wrote {len(manifest)} fixtures, {total} bytes, under {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
