"""JPEG scenes through the port's loaders against the JAX package's:
read_image and read_images (the threaded batch route and its per-image
fallback, the real-data mask rule with JPEG images and masks),
load_cameras_colmap on the committed capture (tests/data/jpeg/capture),
and ``fit_3dgs --cpu`` for 2 steps on a tiny Pillow-written JPEG capture.
Numpy, the loaders and the fit's plain versions: JAX compiles nothing."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from splatformer_tpu.data import dataset as jds  # noqa: E402
from splatformer_tpu.data import nerfstudio as jns  # noqa: E402
from splatformer_tpu_torch import fit_3dgs  # noqa: E402
from splatformer_tpu_torch.data import colmap as tcm  # noqa: E402
from splatformer_tpu_torch.data import dataset as tds  # noqa: E402
from splatformer_tpu_torch.data import nerfstudio as tns  # noqa: E402

CAPTURE = os.path.join(os.path.dirname(__file__), "data", "jpeg", "capture")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jpeg(path, img, **kw):
    Image.fromarray(img).save(path, "JPEG", **kw)


def test_read_image_and_read_images_on_jpeg_scenes(tmp_path):
    """Same-shaped JPEG views take one decode_batch in both packages; a
    real-data folder with JPEG masks takes read_image per path, the mask
    kept as a 4th channel; both equal the JAX package's values."""
    rng = np.random.default_rng(31)
    bg = np.array([0.25, 0.5, 1.0], np.float32)
    scene = tmp_path / "scene" / "images"
    scene.mkdir(parents=True)
    paths = []
    for i in range(5):
        p = str(scene / f"frame_{i:05d}.jpg")
        _jpeg(p, rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
              quality=85, progressive=i == 2)
        paths.append(p)
    for p in paths:
        assert np.array_equal(tds.read_image(p, bg), jds.read_image(p, bg))
    got, want = tds.read_images(paths, bg), jds.read_images(paths, bg)
    assert len(got) == len(want) == 5
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

    for sub in ("realOOD/images", "realOOD/masks"):
        (tmp_path / sub).mkdir(parents=True)
    real = []
    for i in range(3):
        img = str(tmp_path / f"realOOD/images/v{i}.jpg")
        _jpeg(img, rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
        mask = rng.integers(0, 2, (16, 24), dtype=np.uint8) * np.uint8(255)
        Image.fromarray(mask, "L").save(
            str(tmp_path / f"realOOD/masks/v{i}.jpg"), "JPEG", quality=95)
        real.append(img)
    got, want = tds.read_images(real, bg), jds.read_images(real, bg)
    assert all(g.shape == (16, 24, 4) for g in got)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_load_cameras_colmap_on_committed_capture():
    meta_t, train_t, test_t = tns.load_cameras_colmap(CAPTURE)
    meta_j, train_j, test_j = jns.load_cameras_colmap(CAPTURE)
    assert train_t == train_j and test_t == test_j
    assert len(train_t) == 10 and len(test_t) == 2
    assert all(p.endswith(".jpg") for p in train_t + test_t)
    assert meta_t.keys() == meta_j.keys()
    for k in meta_t:
        assert np.array_equal(np.asarray(meta_t[k]), np.asarray(meta_j[k])), k
    bg = np.zeros(3, np.float32)
    for a, b in zip(tds.read_images(train_t[:4], bg),
                    jds.read_images(train_j[:4], bg)):
        assert a.shape == (512, 512, 3) and np.array_equal(a, b)


def test_fit_3dgs_cpu_on_jpeg_capture(tmp_path, capsys):
    """Two fit steps on a 32x32 JPEG capture of 4 training views and a
    held-out one: exit 0, finite Gaussians, the npz lists the .jpg views."""
    rng = np.random.default_rng(32)
    root = tmp_path / "cap"
    (root / "images").mkdir(parents=True)
    hw = 32
    cameras = {1: tcm.ColmapCamera(1, "PINHOLE", hw, hw,
                                   np.array([38.4, 38.4, 16.0, 16.0]))}
    images = {}
    for i in range(5):     # 4 training views and 1 held out
        name = f"frame_{i:05d}.jpg" if i < 4 else "test_00.jpg"
        _jpeg(str(root / "images" / name),
              rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
        ang = 2 * np.pi * i / 5
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])
        images[i + 1] = tcm.ColmapImage(
            i + 1, q, np.array([0.0, 0.0, 3.0]), 1, name, np.zeros((0, 2)),
            np.zeros((0,), np.int64))
    points = {j + 1: tcm.ColmapPoint3D(
        j + 1, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
        0.0, np.zeros((0,), np.int64), np.zeros((0,), np.int64))
        for j in range(64)}
    tcm.write_model(cameras, images, points, str(root / "sparse" / "0"),
                    ext=".bin")
    out = str(tmp_path / "scene.npz")
    rc = fit_3dgs.main(["--colmap", str(root), "--out", out, "--steps", "2",
                        "--capacity", "256", "--log_every", "1",
                        "--max_intersects", "16384", "--cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "kernel launches: " in text and "train-view:" in text
    z = np.load(out)
    assert [str(p).endswith(".jpg") for p in z["train_imgs_path"]] == [True] * 4
    assert np.isfinite(z["gs/means"]).all() and len(z["gs/means"]) > 0
