"""The port's data I/O against the JAX package on the same inputs:
transforms and COLMAP files (bit-identical, each package reading the
other's), rotmat_to_quat, procgen scenes and ring cameras, the nerfstudio
loader and its npz cache, and the port's PNG decoder against the JAX
package's read_image (libpng through native/io.cc) on PIL-written files of
every colour type and on a file of all five row filters, the real-data
mask rule included. Numpy and the loaders only: nothing is compiled."""
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from splatformer_tpu.data import colmap as jcm  # noqa: E402
from splatformer_tpu.data import dataset as jds  # noqa: E402
from splatformer_tpu.data import native_io  # noqa: E402
from splatformer_tpu.data import nerfstudio as jns  # noqa: E402
from splatformer_tpu.data import procgen as jpg  # noqa: E402
from splatformer_tpu.data.synthetic import single_camera as j_single  # noqa: E402
from splatformer_tpu.data import transforms as jtr  # noqa: E402
from splatformer_tpu.ops.camera import rotmat_to_quat as j_r2q  # noqa: E402
from splatformer_tpu_torch.data import colmap as tcm  # noqa: E402
from splatformer_tpu_torch.data import dataset as tds  # noqa: E402
from splatformer_tpu_torch.data import image_io  # noqa: E402
from splatformer_tpu_torch.data import nerfstudio as tns  # noqa: E402
from splatformer_tpu_torch.data import procgen as tpg  # noqa: E402
from splatformer_tpu_torch.data import transforms as ttr  # noqa: E402
from splatformer_tpu_torch.data.synthetic import single_camera as t_single  # noqa: E402
from splatformer_tpu_torch.ops.camera import rotmat_to_quat as t_r2q  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_transforms_exact():
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(500, 3)) * [1.0, 3.0, 0.5]).astype(np.float32)
    pts[:5] *= 40.0
    for kw in ({}, {"n_devs": 2.0}, {"center": np.zeros(3, np.float32)},
               {"already_centered": True, "take_biggest_std": True}):
        a, ma = jtr.remove_outliers(pts, **kw)
        b, mb = ttr.remove_outliers(pts, **kw)
        assert np.array_equal(a, b) and np.array_equal(ma, mb)
    for kw in ({}, {"already_centered": True},
               {"already_centered": True, "already_scaled": True}):
        js, ts = jtr.MinMaxScaler(**kw), ttr.MinMaxScaler(**kw)
        assert np.array_equal(js.fit_transform(pts), ts.fit_transform(pts))
        assert np.array_equal(js.inverse_transform(pts[:9]),
                              ts.inverse_transform(pts[:9]))


def _model(mod, rng):
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 64, 48,
                                np.array([50.5, 51.25, 32.0, 24.0])),
            2: mod.ColmapCamera(2, "OPENCV", 64, 48, rng.normal(size=8))}
    images = {}
    for i in range(1, 4):
        q = rng.normal(size=4)
        images[i] = mod.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"frame_{i:05d}.png", rng.normal(size=(i, 2)),
            rng.integers(-1, 9, size=i))
    points = {j: mod.ColmapPoint3D(
        j, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
        float(rng.uniform()), rng.integers(1, 4, size=j),
        rng.integers(0, 5, size=j)) for j in range(1, 5)}
    return cams, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_files_identical_and_cross_read(tmp_path, ext):
    """Both writers give the same bytes from the same model; each package
    reads the other's files to the same values."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jcm.write_model(*_model(jcm, np.random.default_rng(1)), jdir, ext=ext)
    tcm.write_model(*_model(tcm, np.random.default_rng(1)), tdir, ext=ext)
    for name in ("cameras", "images", "points3D"):
        assert (jdir / f"{name}{ext}").read_bytes() == \
            (tdir / f"{name}{ext}").read_bytes(), name
    for reader, path in ((tcm.read_model, jdir), (jcm.read_model, tdir)):
        for a, b in zip(reader(path), jcm.read_model(jdir)):
            assert a.keys() == b.keys()
            for k in a:
                for f in vars(b[k]):
                    np.testing.assert_array_equal(getattr(a[k], f),
                                                  getattr(b[k], f))
    cam = tcm.read_model(jdir)[0][1]
    assert tcm.parse_colmap_camera_params(cam) == \
        jcm.parse_colmap_camera_params(cam)


def test_qvec_and_rotmat_to_quat():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.stack([jcm.qvec2rotmat(x) for x in q])
    for r in R[:8]:
        assert np.array_equal(tcm.rotmat2qvec(r), jcm.rotmat2qvec(r))
        assert np.array_equal(tcm.qvec2rotmat(jcm.rotmat2qvec(r)),
                              jcm.qvec2rotmat(jcm.rotmat2qvec(r)))
    R32 = R.astype(np.float32)
    got = t_r2q(torch.from_numpy(R32)).numpy()
    want = np.asarray(j_r2q(jnp.asarray(R32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the same rotation: q or -q
    np.testing.assert_allclose(np.abs((got * q).sum(1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7, 10_003])
def test_procgen_bit_identical(seed):
    """Scenes, ring cameras and one view of them (single_camera)."""
    j = jpg.make_gt_scene(seed, n_gauss=700)
    t = tpg.make_gt_scene(seed, n_gauss=700, device="cpu")
    for k in ("means", "scales", "quats", "opacities", "features_dc",
              "features_rest", "mask"):
        assert np.array_equal(np.asarray(getattr(j, k)),
                              getattr(t, k).numpy()), k
    for elev, n_az, jit in (([0.0, 10.0], 7, 0.15), ([70.0, 80.0, 90.0], 3,
                                                     0.3)):
        jc = jpg.ring_cameras(elev, n_az, 48, 40, az_jitter=jit, seed=seed)
        tc = tpg.ring_cameras(elev, n_az, 48, 40, az_jitter=jit, seed=seed,
                              device="cpu")
        for k in ("c2w", "fx", "fy", "cx", "cy"):
            assert np.array_equal(np.asarray(getattr(jc, k)),
                                  getattr(tc, k).numpy()), k
            assert np.array_equal(
                np.asarray(getattr(j_single(jc, 2), k)),
                getattr(t_single(tc, 2), k).numpy()), k
        assert (jc.width, jc.height) == (tc.width, tc.height)


def _scene_folder(root, rng, n=300, hw=16):
    """A nerfstudio checkpoint (NaN and far rows included) and a COLMAP
    folder of 3 input and 2 test views, written with the JAX writers."""
    ns_dir = root / "nerfstudio" / "sceneA" / "splatfacto"
    (ns_dir / "nerfstudio_models").mkdir(parents=True)
    raw = {"means": rng.normal(size=(n, 3)), "scales": rng.normal(size=(n, 3)),
           "quats": rng.normal(size=(n, 4)),
           "opacities": rng.normal(size=(n, 1)),
           "features_dc": rng.normal(size=(n, 3)),
           "features_rest": rng.normal(size=(n, 3, 3))}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    raw["means"][3] = np.nan
    raw["features_rest"][5, 1, 2] = np.nan
    raw["means"][7] = 50.0
    torch.save({"pipeline": {f"_model.gauss_params.{k}": torch.from_numpy(v)
                             for k, v in raw.items()}},
               ns_dir / "nerfstudio_models" / "step-000001999.ckpt")
    cm_dir = root / "colmap" / "sceneA"
    (cm_dir / "images").mkdir(parents=True)
    images = {}
    for i, name in enumerate(["frame_00000.png", "frame_00001.png",
                              "frame_00002.png", "test_00.png",
                              "test_01.png"]):
        q = rng.normal(size=4)
        images[i + 1] = jcm.ColmapImage(i + 1, q / np.linalg.norm(q),
                                        rng.normal(size=3), 1, name,
                                        np.zeros((0, 2)),
                                        np.zeros(0, np.int64))
        Image.fromarray(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
                        ).save(cm_dir / "images" / name)
    cams = {1: jcm.ColmapCamera(1, "PINHOLE", hw, hw,
                                np.array([20.0, 20.0, hw / 2, hw / 2]))}
    jcm.write_model(cams, images, {}, cm_dir / "sparse" / "0")
    return str(ns_dir), str(cm_dir)


def _assert_scene_equal(a, b):
    assert a["gs_params"].keys() == b["gs_params"].keys()
    for k in a["gs_params"]:
        assert np.array_equal(a["gs_params"][k], b["gs_params"][k]), k
    assert a["meta"].keys() == b["meta"].keys()
    for k in a["meta"]:
        assert np.array_equal(a["meta"][k], b["meta"][k]), k
    for k in ("scene_name", "train_imgs_path", "test_imgs_path"):
        assert a[k] == b[k], k


def test_nerfstudio_loader_and_npz_cache(tmp_path):
    ns_dir, cm_dir = _scene_folder(tmp_path, np.random.default_rng(3))
    raw = tns.load_gauss_params_ckpt(ns_dir)
    for kw in ({}, {"remove_outlier_ndevs": 2.0, "max_gs_num": 250}):
        (pa, sa), (pb, sb) = (tns.prepare_gs_params(raw, **kw),
                              jns.prepare_gs_params(raw, **kw))
        for k in pb:
            assert np.array_equal(pa[k], pb[k]), k
        assert np.array_equal(sa.scale_, sb.scale_)
    t = tns.load_scene(ns_dir, cm_dir, "colmap")
    j = jns.load_scene(ns_dir, cm_dir, "colmap")
    _assert_scene_equal(t, j)
    assert len(t["test_imgs_path"]) == 2 and len(t["train_imgs_path"]) == 3
    tns.convert_scene_to_npz(ns_dir, cm_dir, str(tmp_path / "t.npz"),
                             load_pose_src="colmap")
    jns.convert_scene_to_npz(ns_dir, cm_dir, str(tmp_path / "j.npz"),
                             load_pose_src="colmap")
    for path in ("t.npz", "j.npz"):
        back = tns.load_scene_npz(str(tmp_path / path))
        _assert_scene_equal(back, jns.load_scene_npz(str(tmp_path / "j.npz")))
        for k in j["gs_params"]:
            assert np.array_equal(back["gs_params"][k], j["gs_params"][k])


def _images(rng, h=13, w=11):
    """PIL images of every mode the factory and real data use; smooth
    content plus noise, so PIL's adaptive filtering picks every one of the
    five row filters over the set."""
    y, x = np.mgrid[:h, :w]

    def smooth(c):
        base = np.stack([(np.sin(x / 3 + k) + np.cos(y / 4 - k)) * 60 + 128
                         for k in range(c)], -1)
        return np.clip(base + rng.normal(0, 6, base.shape), 0,
                       255).astype(np.uint8)
    rgb = Image.fromarray(smooth(3), "RGB")
    return {"rgb": rgb, "rgba": Image.fromarray(smooth(4), "RGBA"),
            "gray": Image.fromarray(smooth(1)[..., 0], "L"),
            "gray_alpha": Image.fromarray(smooth(2), "LA"),
            "palette": rgb.convert("P"), "bilevel": rgb.convert("1"),
            "noise": Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8), "RGB")}


def _filters(path):
    """The row filter types of a non-interlaced PNG."""
    data = open(path, "rb").read()
    pos, idat, h = 8, b"", 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            h = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(rows[:, 0].tolist())


def _write_filtered(path, img):
    """An 8-bit RGB PNG whose rows take the filters 0-4 in turn (PIL picks
    its filters itself and rarely picks 3)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), x[r, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        f = r % 5
        pred = [0, left, up, (left + up) >> 1, paeth][f]
        rows.append(bytes([f]) + ((x[r] - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def test_png_decoder_matches_jax_read_image(tmp_path):
    """Exact agreement with the JAX package's decoder and read_image
    compositing on every mode; the files hold all five filter types."""
    assert native_io.available(), "native/libsplatformer_io.so is the reference"
    rng = np.random.default_rng(4)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    filters = set()
    images = _images(rng)
    images["all_filters"] = None
    for name, im in images.items():
        path = str(tmp_path / f"{name}.png")
        if im is None:
            _write_filtered(path, np.asarray(images["noise"]))
        else:
            im.save(path)
        filters |= _filters(path)
        want = native_io.decode_image(path)
        got = image_io.decode_image(path)
        assert got.dtype == np.float32
        assert np.array_equal(got, want), name
        assert np.array_equal(tds.read_image(path, bg),
                              jds.read_image(path, bg)), name
    assert filters == {0, 1, 2, 3, 4}, filters
    batch = [str(tmp_path / f"{n}.png") for n in ("rgb", "noise")]
    for a, b in zip(tds.read_images(batch, bg), jds.read_images(batch, bg)):
        assert np.array_equal(a, b)


def test_real_data_mask_rule_and_refusals(tmp_path):
    """A path with "real" in it and a masks/ sibling keeps the mask as a
    4th channel; JPEG is refused by name."""
    rng = np.random.default_rng(5)
    bg = np.array([1.0, 0.0, 0.5], np.float32)
    for sub in ("realOOD/images", "realOOD/masks"):
        (tmp_path / sub).mkdir(parents=True)
    img = str(tmp_path / "realOOD/images/a.png")
    Image.fromarray(rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)).save(img)
    Image.fromarray(rng.integers(0, 256, (9, 7), dtype=np.uint8), "L").save(
        str(tmp_path / "realOOD/masks/a.png"))
    got, want = tds.read_image(img, bg), jds.read_image(img, bg)
    assert got.shape == (9, 7, 4) and np.array_equal(got, want)
    assert np.array_equal(tds.read_images([img, img], bg)[1],
                          jds.read_images([img, img], bg)[1])
    jpg_path = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        jpg_path)
    with pytest.raises(NotImplementedError, match="JPEG"):
        image_io.decode_image(jpg_path)
