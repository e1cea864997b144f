"""The port's scene loader (data/dataset.py) against the JAX package's on
a tiny factory folder (2 train scenes and 1 test scene of a few hundred
Gaussians, 16^2 images), written once with the port's writer and once
with scripts/make_ood_benchmark.py's: identical samples (the first 6
training samples with augmentation on, every test sample) whichever
package wrote the folder and whichever reads it, the process sharding of
both splits, the scene cache's eviction, prefetch_iterator's order and
to_scene_batch's tensors against the JAX SceneBatch. Numpy only: nothing
is compiled."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu.data import dataset as jds  # noqa: E402
from splatformer_tpu.data import procgen as jpg  # noqa: E402
from splatformer_tpu_torch import make_ood_benchmark as tmk  # noqa: E402
from splatformer_tpu_torch.configs import build_full_config  # noqa: E402
from splatformer_tpu_torch.data import dataset as tds  # noqa: E402
from splatformer_tpu_torch.data import procgen as tpg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUGMENT = dict(build_full_config(dataset="oodbench").dataset.train.augment)
HW = 16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_make_ood_benchmark",
        os.path.join(REPO, "scripts", "make_ood_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(root, writer, cams):
    """The factory's layout for train scenes 0, 1 and test scene 10000: a
    procgen scene stands in for the fitted one; images are seeded noise
    (the loader reads them, nothing renders them)."""
    for split, seed in (("train", 0), ("train", 1), ("test", 10_000)):
        rng = np.random.default_rng(seed)
        gt = tpg.make_gt_scene(seed, n_gauss=600, device="cpu")
        gs = {k: getattr(gt, k).numpy()[: 250 + 20 * (seed % 3)]
              for k in ("means", "scales", "quats", "opacities",
                        "features_dc", "features_rest")}
        imgs_in = rng.uniform(size=(14, HW, HW, 3)).astype(np.float32)
        imgs_ood = rng.uniform(size=(9, HW, HW, 3)).astype(np.float32)
        c_in = cams["in"](seed)
        c_ood = cams["ood"](seed)
        writer(os.path.join(root, split), f"scene{seed:05d}", gs, c_in,
               c_ood, imgs_in, imgs_ood, gs["means"],
               gs["features_dc"] * 0.28209479177387814 + 0.5)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """{"port": root, "jax": root}: the same scenes by each writer."""
    root = tmp_path_factory.mktemp("factory")
    port_cams = {
        "in": lambda s: tpg.ring_cameras([0.0, 10.0], 7, HW, HW,
                                         az_jitter=0.15, seed=s,
                                         device="cpu"),
        "ood": lambda s: tpg.ring_cameras([70.0, 80.0, 90.0], 3, HW, HW,
                                          az_jitter=0.3, seed=s + 1,
                                          device="cpu")}
    jax_cams = {
        "in": lambda s: jpg.ring_cameras([0.0, 10.0], 7, HW, HW,
                                         az_jitter=0.15, seed=s),
        "ood": lambda s: jpg.ring_cameras([70.0, 80.0, 90.0], 3, HW, HW,
                                          az_jitter=0.3, seed=s + 1)}
    _write(str(root / "port"), tmk.write_scene_folder, port_cams)
    _write(str(root / "jax"), _jax_script().write_scene_folder, jax_cams)
    return {"port": str(root / "port"), "jax": str(root / "jax")}


def _ds(mod, root, split, **kw):
    base = os.path.join(root, split)
    return mod.SplatfactoScenes(
        split, os.path.join(base, "nerfstudio"), os.path.join(base, "colmap"),
        load_pose_src="colmap", max_gs_num=1024, pad_to=1024, **kw)


def _assert_same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys()
            for kk in a[k]:
                assert np.array_equal(a[k][kk], b[k][kk]), (k, kk)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_folder_layout_and_cross_writers(folders):
    """Both writers give the layout and byte-identical COLMAP binaries
    (their checkpoints and PNGs load to the same values: the sample
    tests)."""
    for root in folders.values():
        for split, name in (("train", "scene00000"), ("train", "scene00001"),
                            ("test", "scene10000")):
            base = os.path.join(root, split)
            assert os.path.exists(os.path.join(
                base, "nerfstudio", name, "splatfacto", "nerfstudio_models",
                "step-000001999.ckpt"))
            images = sorted(os.listdir(os.path.join(base, "colmap", name,
                                                    "images")))
            assert images == ([f"frame_{i:05d}.png" for i in range(14)]
                              + [f"test_{i:02d}.png" for i in range(9)])
    for sub in ("cameras.bin", "images.bin", "points3D.bin"):
        rel = os.path.join("test", "colmap", "scene10000", "sparse", "0", sub)
        with open(os.path.join(folders["port"], rel), "rb") as f, \
                open(os.path.join(folders["jax"], rel), "rb") as g:
            assert f.read() == g.read(), sub


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_train_samples_identical(folders, writer):
    """The first 6 training samples (augmentation on) of the port's loader
    and the JAX one on the same folder, and of the port's loader on the
    other writer's folder."""
    other = folders["jax" if writer == "port" else "port"]
    kw = dict(augment=AUGMENT, sample_ratio_test=0.7, image_per_scene=4,
              background_color="random", cache_steps=4, cache_num_scenes=4,
              seed=3)
    t_it = _ds(tds, folders[writer], "train", **kw).iter_train()
    j_it = _ds(jds, folders[writer], "train", **kw).iter_train()
    o_it = _ds(tds, other, "train", **kw).iter_train()
    augmented = 0
    for _ in range(6):
        t, j, o = next(t_it), next(j_it), next(o_it)
        _assert_same_sample(t, j)
        _assert_same_sample(o, j)
        augmented += int(t["gs_mask"].sum()) > 270
        assert t["images"].shape == (4, HW, HW, 3)
    assert augmented > 0  # floaters were injected into some samples


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_test_samples_identical(folders, writer):
    kw = dict(background_color=[0, 0, 0])
    got = list(_ds(tds, folders[writer], "test", **kw).iter_test())
    want = list(_ds(jds, folders[writer], "test", **kw).iter_test())
    assert len(got) == len(want) == 1
    _assert_same_sample(got[0], want[0])
    assert got[0]["images"].shape == (9, HW, HW, 3)


@pytest.mark.parametrize("count", [2, 3])
def test_process_sharding(folders, count):
    """Each process's test scenes and per-epoch training permutations, as
    the JAX loader gives them."""
    for index in range(count):
        for split in ("train", "test"):
            t = _ds(tds, folders["port"], split, process_index=index,
                    process_count=count)
            j = _ds(jds, folders["port"], split, process_index=index,
                    process_count=count)
            assert t.scene_ids == j.scene_ids
        t = _ds(tds, folders["port"], "train", process_index=index,
                process_count=count, seed=5)
        j = _ds(jds, folders["port"], "train", process_index=index,
                process_count=count, seed=5)
        for _ in range(4):
            assert t._train_epoch_ids() == j._train_epoch_ids()


def test_cache_eviction(folders, monkeypatch):
    """Scene loads and cache contents step by step, as the JAX loader's:
    a scene is kept for cache_steps uses, at most cache_num_scenes."""
    loads = {"port": [], "jax": []}
    for name, mod in (("port", tds), ("jax", jds)):
        orig = mod.SplatfactoScenes.load_scene

        def counting(self, idx, _orig=orig, _log=loads[name]):
            _log.append(idx)
            return _orig(self, idx)
        monkeypatch.setattr(mod.SplatfactoScenes, "load_scene", counting)
    t = _ds(tds, folders["port"], "train", cache_steps=3, cache_num_scenes=1)
    j = _ds(jds, folders["port"], "train", cache_steps=3, cache_num_scenes=1)
    for idx in (0, 0, 1, 0, 0, 1, 1, 1, 0):
        t._cached_scene(idx)
        j._cached_scene(idx)
        assert [(e[0]["idx"], e[1]) for e in t._cache] == \
            [(e[0]["idx"], e[1]) for e in j._cache]
    assert loads["port"] == loads["jax"]
    assert len(loads["port"]) < 9


def test_prefetch_iterator_order():
    assert list(tds.prefetch_iterator(iter(range(100)), depth=3)) == \
        list(range(100))
    assert list(tds.prefetch_iterator(iter(range(5)), depth=0)) == \
        list(jds.prefetch_iterator(iter(range(5)), depth=0))

    def failing():
        yield 1
        raise ValueError("loader failed")
    it = tds.prefetch_iterator(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="loader failed"):
        next(it)


def test_to_scene_batch_matches_jax(folders):
    sample = next(iter(_ds(tds, folders["port"], "test",
                           background_color=[0, 0, 0]).iter_test()))
    t = tds.to_scene_batch(sample, "cpu")
    j = jds.to_scene_batch([sample])

    def same(a, b):
        b = np.asarray(b)[0]
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    for k in ("means", "scales", "quats", "opacities", "features_dc",
              "features_rest", "mask"):
        same(getattr(t.scene, k), getattr(j.scene, k))
    for k in ("c2w", "fx", "fy", "cx", "cy"):
        same(getattr(t.cameras, k), getattr(j.cameras, k))
    assert (t.cameras.width, t.cameras.height) == (j.cameras.width,
                                                    j.cameras.height)
    same(t.images, j.images)
    same(t.background, j.background)


@pytest.mark.parametrize("name", ["oodbench", "oodbench_scale",
                                  "oodbench_512", "objaverse", "shapenet"])
def test_dataset_configs_match_jax(name):
    """The port's dataset config has the JAX one's fields and values (an
    empty ``train.augment``, where the JAX config has none, flattens to no
    field: the JAX loop reads a missing one as empty)."""
    import dataclasses

    from splatformer_tpu.configs import load_config as jax_load_config
    from splatformer_tpu_torch.configs import load_config

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and k != "folders":
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return v
    j = flat(jax_load_config("dataset", name).to_dict())
    p = flat(dataclasses.asdict(load_config("dataset", name)))
    assert set(p) == set(j), sorted(set(p) ^ set(j))
    for k in j:
        assert norm(p[k]) == norm(j[k]), (k, p[k], j[k])
