"""The port's data factory end to end on the CPU, torch only: the
make_ood_benchmark generator with --cpu at a tiny size (1 train scene and 1
test scene, 20 fit steps) writes the scene folders and skips done scenes
on a second call; the train CLI trains on them (--dataset oodbench with
the folders overridden, 2 steps with an eval, the config's 2 prefetch
workers) and --only_eval --compare_with_input scores them; prepare_data
caches them as npz and fit_3dgs fits one from its COLMAP folder; a dataset
name that has no config raises by name."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch import fit_3dgs  # noqa: E402
from splatformer_tpu_torch import make_ood_benchmark  # noqa: E402
from splatformer_tpu_torch import prepare_data  # noqa: E402
from splatformer_tpu_torch import train as train_cli  # noqa: E402
from splatformer_tpu_torch.configs import build_full_config  # noqa: E402
from splatformer_tpu_torch.data import nerfstudio  # noqa: E402
from splatformer_tpu_torch.models.lpips import write_synthetic_weights  # noqa: E402
from splatformer_tpu_torch.training import checkpoints as ckpt_lib  # noqa: E402

TINY_MODEL = [
    "model.backbone.enc_channels=(8, 16)", "model.backbone.dec_channels=(8,)",
    "model.backbone.enc_depths=(1, 1)", "model.backbone.enc_num_head=(1, 2)",
    "model.backbone.dec_depths=(1,)", "model.backbone.dec_num_head=(1,)",
    "model.backbone.stride=(2,)", "model.backbone.patch_size=16",
    "model.backbone.pool_capacity_factors=(1.0,)",
    "model.output_head_width=16", "model.output_head_nlayer=2",
    "model.grid_resolution=32", "model.zeroinit=False", "train.bf16=False",
]
GENERATOR = ["--cpu", "--n_train_scenes", "1", "--n_test_scenes", "1",
             "--n_gauss", "640", "--capacity", "512", "--hw", "32",
             "--fit_steps", "20", "--fit_warmup", "5", "--seed_points",
             "256", "--max_intersects", "8192", "--tiles_per_gauss", "16"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("factory") / "oodbench")
    assert make_ood_benchmark.main(["--out", out] + GENERATOR) == 0
    return out


def test_generator_writes_layout_and_skips_done_scenes(bench_dir, capsys):
    for split, name in (("train", "scene00000"), ("test", "scene10000")):
        base = os.path.join(bench_dir, split)
        assert os.path.exists(os.path.join(
            base, "nerfstudio", name, "splatfacto", "nerfstudio_models",
            "step-000001999.ckpt"))
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            assert os.path.exists(os.path.join(base, "colmap", name, "sparse",
                                               "0", f))
        images = sorted(os.listdir(os.path.join(base, "colmap", name,
                                                "images")))
        assert images == ([f"frame_{i:05d}.png" for i in range(14)]
                          + [f"test_{i:02d}.png" for i in range(9)])
    with open(os.path.join(bench_dir, "generation_summary.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["split"], r["scene"]) for r in rows] == [
        ("train", "scene00000"), ("test", "scene10000")]
    for r in rows:
        assert 0 < r["n_gauss"] <= 512 and r["n_seed_visible"] > 0
        assert np.isfinite(r["fit_psnr_input_views"])
        assert np.isfinite(r["fit_psnr_ood_views"])
    capsys.readouterr()
    assert make_ood_benchmark.main(["--out", bench_dir] + GENERATOR) == 0
    out = capsys.readouterr().out
    assert out.count("[skip]") == 2 and "wrote 0 scenes" in out
    with open(os.path.join(bench_dir, "generation_summary.jsonl")) as f:
        assert len(f.readlines()) == 2
    if not torch.cuda.is_available():
        assert make_ood_benchmark.main(["--out", bench_dir]) == 1


def test_train_and_eval_cli_on_factory_folder(bench_dir, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    lp = str(tmp_path / "lpips.npz")
    write_synthetic_weights(lp)
    folders = {"oodbench": (f"{bench_dir}/test/nerfstudio",
                            f"{bench_dir}/test/colmap")}
    overrides = TINY_MODEL + [
        f"dataset.train.nerfstudio_folder='{bench_dir}/train/nerfstudio'",
        f"dataset.train.colmap_folder='{bench_dir}/train/colmap'",
        f"dataset.test.folders={folders!r}",
        "dataset.max_gs_num=1024", "dataset.pad_to=1024",
        "train.eval_interval=1", "train.log_interval=1",
        f"train.lpips_weights_path='{lp}'"]
    cfg = build_full_config(dataset="oodbench", overrides=overrides)
    assert cfg.dataset.num_workers == 2 and cfg.dataset.train.augment
    args = ["--cpu", "--dataset", "oodbench", "--output_dir", "run"]
    for o in overrides:
        args += ["--override", o]
    assert train_cli.main(args + ["--max_steps", "2"]) == 0
    with open("run/history.json") as f:
        history = json.load(f)
    assert [h["step"] for h in history] == [0, 1]
    assert all(h["num_dropped"] == 0 and np.isfinite(h["total_loss"])
               for h in history)
    with open("run/eval.csv") as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["dataset", "step", "psnr", "ssim", "lpips",
                       "input_psnr", "input_ssim", "input_lpips"]
    assert [r[:2] for r in rows[1:]] == [["oodbench", "1"]]
    assert all(np.isfinite(float(x)) for x in rows[1][2:])
    assert os.path.exists("run/eval/oodbench/1/scene10000_pred.png")
    assert ckpt_lib.latest_step("run/checkpoints") == 2

    assert train_cli.main(args + ["--only_eval", "--compare_with_input",
                                  "--eval_subdir", "final"]) == 0
    with open("eval.csv") as f:
        rows = [line.strip().split(",") for line in f]
    assert len(rows) == 2 and rows[1][0] == "oodbench"
    assert all(np.isfinite(float(x)) for x in rows[1][1:4])
    with open("run/final/oodbench/metrics_input.rank0.json") as f:
        assert "scene10000" in json.load(f)


def test_unknown_dataset_raises_by_name():
    with pytest.raises(NotImplementedError, match="'no_such_set'"):
        train_cli.main(["--cpu", "--dataset", "no_such_set"])


def test_prepare_data_and_fit_3dgs(bench_dir, tmp_path, capsys):
    """prepare_data's npz caches load as the folders do; fit_3dgs fits a
    scene from its COLMAP folder (images, sparse/0 and its points3D) into
    the same npz schema."""
    cache = str(tmp_path / "cache")
    args = ["--nerfstudio", f"{bench_dir}/test/nerfstudio",
            "--colmap", f"{bench_dir}/test/colmap", "--out", cache,
            "--load_pose_src", "colmap"]
    assert prepare_data.main(args) == 0
    assert "converted scene10000" in capsys.readouterr().out
    cached = nerfstudio.load_scene_npz(f"{cache}/scene10000.npz")
    direct = nerfstudio.load_scene(
        f"{bench_dir}/test/nerfstudio/scene10000/splatfacto",
        f"{bench_dir}/test/colmap/scene10000", "colmap")
    for k, v in direct["gs_params"].items():
        assert np.array_equal(cached["gs_params"][k], v), k
    assert cached["test_imgs_path"] == direct["test_imgs_path"]
    assert prepare_data.main(args) == 0          # done scenes are skipped
    assert "converted" not in capsys.readouterr().out

    out = str(tmp_path / "fit.npz")
    fit_args = ["--cpu", "--colmap", f"{bench_dir}/train/colmap/scene00000",
                "--out", out, "--steps", "8", "--capacity", "2048",
                "--max_intersects", "16384", "--log_every", "0"]
    ply = str(tmp_path / "x.ply")
    assert fit_3dgs.main(fit_args + ["--ply", ply]) == 0
    fitted = nerfstudio.load_scene_npz(out)
    n = fitted["gs_params"]["means"].shape[0]
    assert 0 < n <= 2048 and len(fitted["train_imgs_path"]) == 14
    assert all(np.isfinite(v).all() for v in fitted["gs_params"].values())
    # the viewer PLY holds the same live Gaussians
    from splatformer_tpu_torch.utils.viewer import read_ply
    fields = read_ply(ply)
    assert np.array_equal(fields["x"], fitted["gs_params"]["means"][:, 0])
    assert np.array_equal(fields["opacity"],
                          fitted["gs_params"]["opacities"].reshape(n))
