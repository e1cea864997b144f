"""The port's training plumbing, torch only: checkpoints (bit-exact
round-trip, max_to_keep, atomic saves, the partial-load report),
MetricComputer against values the JAX package computed once, the PNG
writer, the eval.csv schemas, and the train CLI and the bench on the CPU
at a tiny size."""
import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch import bench  # noqa: E402
from splatformer_tpu_torch import train as train_cli  # noqa: E402
from splatformer_tpu_torch.configs import build_full_config  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    build_feature_predictor)
from splatformer_tpu_torch.models.lpips import (make_lpips_fn,  # noqa: E402
                                                write_synthetic_weights)
from splatformer_tpu_torch.training import checkpoints as ckpt_lib  # noqa: E402
from splatformer_tpu_torch.training.loop import (  # noqa: E402
    RUN_EVAL_CSV_HEADER, build_train_state, make_synthetic_data)
from splatformer_tpu_torch.training.metrics import MetricComputer  # noqa: E402
from splatformer_tpu_torch.training.train_step import make_train_step  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.utils.logging import (log_result_csv,  # noqa: E402
                                                 make_grid, save_image)

TINY = [
    "dataset.n_scenes=2", "dataset.n_gaussians=256", "dataset.pad_to=256",
    "dataset.image_size=32", "dataset.image_per_scene=2",
    "model.backbone.enc_channels=(8, 16)", "model.backbone.dec_channels=(8,)",
    "model.backbone.enc_depths=(1, 1)", "model.backbone.enc_num_head=(1, 2)",
    "model.backbone.dec_depths=(1,)", "model.backbone.dec_num_head=(1,)",
    "model.backbone.stride=(2,)", "model.backbone.patch_size=16",
    "model.backbone.pool_capacity_factors=(1.0,)",
    "model.output_head_width=16", "model.output_head_nlayer=2",
    "model.grid_resolution=32", "model.zeroinit=False", "train.bf16=False",
]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's small CPU runs: torch's
    default, a thread per core in each of the suite's parallel workers,
    oversubscribes the cores they share (the bench test took 107 s beside
    the other workers, 5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_state(overrides=(), seed=0):
    cfg = build_full_config(overrides=TINY + list(overrides))
    model = build_feature_predictor(cfg.model, device="cpu", seed=seed)
    return cfg, build_train_state(cfg, model, "cpu")


RASTER = RasterizeConfig(max_intersects=2 ** 12, tiles_per_gauss=16)


def trained_state(steps=3):
    """A tiny model after ``steps`` Adam micro-steps with accumulation 2
    and drop_path 0.3: moments, a half-full accumulator, BatchNorm
    statistics and a generator that has moved."""
    cfg, state = tiny_state(["dataset.accumulate_step=2"])
    train_iter, _ = make_synthetic_data(cfg.dataset, RASTER, "cpu")
    step = make_train_step(state.model, state.optimizer, RASTER)
    for _ in range(steps):
        step(next(train_iter), state.generator)
        state.step += 1
    return cfg, state, train_iter


def assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for key in ("mu", "nu", "acc"):
        for x, y in zip(oa[key] or [], ob[key] or [], strict=True):
            assert torch.equal(x, y), key
    assert (oa["count"], oa["mini_step"], a.step) == (
        ob["count"], ob["mini_step"], b.step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """Save after 3 micro-steps, restore into a fresh state of other
    weights and generator: every parameter, BatchNorm statistic, moment,
    the accumulator, the counters, the step and the generator equal;
    the next step from either state gives the same metrics."""
    cfg, state, train_iter = trained_state()
    assert state.optimizer.count == 1 and state.optimizer.mini_step == 1
    ckpt_lib.save_checkpoint(str(tmp_path), state, 3)
    _, fresh = tiny_state(["dataset.accumulate_step=2"], seed=5)
    fresh.generator.manual_seed(7)
    restored = ckpt_lib.restore_checkpoint(str(tmp_path), fresh)
    assert restored is fresh
    assert_same_state(state, fresh)

    batch = next(train_iter)
    ma = make_train_step(state.model, state.optimizer, RASTER)(
        batch, state.generator)
    mb = make_train_step(fresh.model, fresh.optimizer, RASTER)(
        batch, fresh.generator)
    # the CPU's threaded scatter-adds may sum in another order from run to
    # run (tests/test_torch_train_step.py): 1e-5 relative
    for k in ma:
        np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=1e-5)


def test_restore_of_empty_directory_keeps_state(tmp_path):
    _, state = tiny_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert ckpt_lib.latest_step(str(tmp_path / "none")) is None
    assert ckpt_lib.restore_checkpoint(str(tmp_path / "none"), state) is state
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in before.items())


def test_max_to_keep_and_replace(tmp_path):
    _, state = tiny_state()
    for step in (1, 5, 3, 9, 7):
        state.step = step
        ckpt_lib.save_checkpoint(str(tmp_path), state, step)
    assert sorted(os.listdir(tmp_path)) == ["5", "7", "9"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 9
    state.step = 42
    ckpt_lib.save_checkpoint(str(tmp_path), state, 9)   # replaces step 9
    assert sorted(os.listdir(tmp_path)) == ["5", "7", "9"]
    assert ckpt_lib.restore_checkpoint(str(tmp_path), state, step=9).step == 42
    assert ckpt_lib.restore_checkpoint(str(tmp_path), state, step=5).step == 5


def test_interrupted_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    _, state = tiny_state()
    ckpt_lib.save_checkpoint(str(tmp_path), state, 1)

    def dies(obj, path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError):
        ckpt_lib.save_checkpoint(str(tmp_path), state, 2)
    monkeypatch.undo()
    assert ckpt_lib.latest_step(str(tmp_path)) == 1
    assert not os.path.exists(tmp_path / "2")
    assert ckpt_lib.restore_checkpoint(str(tmp_path), state).step == 0


def test_partial_load_report(tmp_path):
    """A backbone checkpoint of other widths in one stage: the entries of
    the same shape load, the others keep their values and are reported
    as mismatched, entries the checkpoint lacks as missing; the heads
    (outside the scope) are untouched."""
    _, src = tiny_state(seed=1)
    ckpt_lib.save_checkpoint(str(tmp_path), src, 0)
    _, dst = tiny_state(["model.backbone.dec_channels=(16,)",
                         "model.backbone.dec_depths=(2,)"], seed=2)
    params = {k: p.detach() for k, p in dst.model.named_parameters()}
    merged, report = ckpt_lib.load_partial_params(str(tmp_path), params)
    src_sd = src.model.state_dict()
    assert report["loaded"] and report["missing"] and report["mismatched"]
    for path in report["loaded"]:
        k = path.replace("/", ".")
        assert k.startswith("backbone.") and torch.equal(merged[k], src_sd[k])
    for path in report["missing"] + report["mismatched"]:
        k = path.replace("/", ".")
        assert torch.equal(merged[k], params[k])
        assert (k not in src_sd) == (path in report["missing"])
    assert any("dec0_block1" in p for p in report["missing"])
    heads = [k for k in params if not k.startswith("backbone.")]
    assert heads and all(merged[k] is params[k] for k in heads)
    assert len(report["loaded"]) + len(report["missing"]) + len(
        report["mismatched"]) == len(params) - len(heads)
    nothing = ckpt_lib.load_partial_params(str(tmp_path / "none"), params)
    assert nothing == (params, {"loaded": [], "missing": [],
                                "mismatched": []})


def test_loop_pretrain_accumulation_and_resume_options(tmp_path):
    """run_training's options that the JAX comparison does not use: a
    pretrain step, then gradient accumulation over 2 micro-steps; the
    shape-tolerant backbone load of ``model.resume_ckpt`` (heads keep
    their init); ``train.resume_from_step`` without a checkpoint."""
    from splatformer_tpu_torch.training.loop import run_training
    _, src = tiny_state(seed=1)
    ckpt_lib.save_checkpoint(str(tmp_path / "pre"), src, 0)
    base = TINY + ["train.log_interval=1", "train.eval_interval=0",
                   "train.lpips_weights_path=''"]
    cfg = build_full_config(overrides=base + [
        f"model.resume_ckpt='{tmp_path / 'pre'}'"])
    state = run_training(cfg, str(tmp_path / "load"), max_steps=0,
                         device="cpu")[0]
    got, ref = state.model.state_dict(), src.model.state_dict()
    fresh = build_feature_predictor(cfg.model, device="cpu",
                                    seed=cfg.train.seed).state_dict()
    for k, v in got.items():
        if k.startswith("backbone.") and not k.endswith((".mean", ".var")):
            assert torch.equal(v, ref[k]), k
        elif k.startswith("head_"):
            assert torch.equal(v, fresh[k]), k

    cfg = build_full_config(overrides=base + [
        "train.pretrain_steps=1", "dataset.accumulate_step=2"])
    state = run_training(cfg, str(tmp_path / "acc"), max_steps=2,
                         device="cpu")[0]
    assert (state.step, state.optimizer.count) == (4, 2)
    with open(tmp_path / "acc" / "history.json") as f:
        hist = json.load(f)
    assert [h["step"] for h in hist] == [0, 1]
    assert "pretrain_loss" in hist[0] and "image_l1" in hist[1]
    assert ckpt_lib.latest_step(str(tmp_path / "acc" / "checkpoints")) == 2

    cfg = build_full_config(overrides=base + ["train.resume_from_step=3"])
    state = run_training(cfg, str(tmp_path / "skip"), max_steps=4,
                         device="cpu")[0]
    with open(tmp_path / "skip" / "history.json") as f:
        assert [h["step"] for h in json.load(f)] == [3]
    assert state.step == 4 and state.optimizer.count == 1


# splatformer_tpu.training.metrics.MetricComputer (with the JAX package's
# make_lpips_fn on write_synthetic_weights' file, seed 42) on the inputs
# of metric_inputs(), computed once; tests/test_torch_metrics.py holds
# these against the JAX package live
JAX_RESULTS = {
    "a": {"psnr": [26.20159912109375, 26.38566017150879],
          "ssim": [0.9866001605987549, 0.9869939088821411],
          "lpips": [0.06342534720897675, 0.06182726100087166],
          "input_psnr": 21.5},
    "b": {"psnr": [26.405803680419922, 26.228588104248047],
          "ssim": [0.9873030185699463, 0.9867314100265503],
          "lpips": [0.05872791260480881, 0.0633903220295906]}}
JAX_FINAL = {"psnr": 26.30541229248047, "ssim": 0.9869071245193481,
             "lpips": 0.06184270977973938, "input_psnr": 21.5}
JAX_SUM = {"psnr": 105.22164916992188, "ssim": 3.9476284980773926,
           "lpips": 0.24737083911895752, "input_psnr": 21.5}


def metric_inputs():
    """Two scenes of 2 views at 32^2; the second in 0-255 (MetricComputer
    rescales it)."""
    rng = np.random.default_rng(11)
    for name, scale in (("a", 1.0), ("b", 255.0)):
        gt = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
        pred = np.clip(gt + 0.05 * rng.normal(size=gt.shape), 0,
                       1).astype(np.float32)
        yield name, torch.tensor(pred * scale), torch.tensor(gt * scale)


def test_metric_computer_matches_jax(tmp_path):
    """Per image within 1e-4 dB PSNR and 1e-5 SSIM and LPIPS; the same
    keys, sums, means and JSON layout."""
    path = str(tmp_path / "lpips.npz")
    write_synthetic_weights(path)
    mc = MetricComputer(make_lpips_fn(path, device="cpu"))
    for name, pred, gt in metric_inputs():
        mc.update(pred, gt, name)
    mc.update_value("input_psnr", 21.5, "a")
    tol = {"psnr": 1e-4, "ssim": 1e-5, "lpips": 1e-5, "input_psnr": 0}
    out = str(tmp_path / "metrics.json")
    mc.write_to_file(out)
    with open(out) as f:
        written = json.load(f)
    assert written == mc.results_dict
    assert written.keys() == JAX_RESULTS.keys()
    for name, ref in JAX_RESULTS.items():
        assert written[name].keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(written[name][k], v, rtol=0,
                                       atol=tol[k], err_msg=f"{name} {k}")
    for got, ref in ((mc.finalize(), JAX_FINAL), (mc.sum(), JAX_SUM)):
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 4 * tol[k] + 1e-12, k
    empty = MetricComputer().finalize()
    assert set(empty) == {"psnr", "ssim"} and all(np.isnan(v)
                                                  for v in empty.values())


def read_png(path):
    """Minimal 8-bit PNG decoder (filter 0 rows only), checking every CRC."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, ctype = header[:4]
    assert depth == 8
    c = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c), ctype


@pytest.mark.parametrize("shape,ctype", [((7, 5), 0), ((6, 9, 3), 2),
                                         ((4, 3, 4), 6), ((3, 2, 2), 4)])
def test_png_round_trip(tmp_path, shape, ctype):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "sub" / "img.png")
    save_image(path, img)
    got, got_type = read_png(path)
    assert got_type == ctype
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_png_and_grid_refuse_bad_input(tmp_path):
    with pytest.raises(ValueError):
        save_image(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        save_image(str(tmp_path / "x.png"), np.zeros((4, 4, 5), np.uint8))
    imgs = [np.full((2, 3, 3), i, np.uint8) for i in range(4)]
    grid = make_grid(imgs)
    assert grid.shape == (6, 9, 3)
    assert grid[0, 3, 0] == 1 and grid[2, 0, 0] == 3 and grid[5, 8, 0] == 0


def test_eval_csv_schemas(tmp_path):
    """The reference's eval.csv header byte for byte, its rows, and the
    run-local header of the JAX package's loop (:609-610)."""
    path = str(tmp_path / "eval.csv")
    log_result_csv(path, "synthetic", {"psnr": 30.5, "ssim": 0.9},
                   algo="base", r=0.0, max_mem=12.5)
    log_result_csv(path, "gso", {"psnr": 1.0, "ssim": 2.0, "lpips": 3.0})
    with open(path, "rb") as f:
        assert f.read() == (b"dataset,psnr,ssim,lpips,algo,r,max mem\n"
                            b"synthetic,30.5,0.9,nan,base,0.0,12.5\n"
                            b"gso,1.0,2.0,3.0,base,0.0,0.0\n")
    assert RUN_EVAL_CSV_HEADER == ("dataset,step,psnr,ssim,lpips,input_psnr,"
                                   "input_ssim,input_lpips\n")


def test_train_cli_on_cpu(tmp_path, monkeypatch):
    """Two steps of the tiny configuration through the CLI, then eval-only
    from checkpoints_best with the input compared: the run's files and
    the eval.csv rows (in the working directory, as the root train.py);
    then eval-only of the same checkpoint as ptv3_tome with --merge_rate
    0.5, which appends a tome row at r 0.5. Without --cpu and without a
    card the CLI exits 1."""
    monkeypatch.chdir(tmp_path)
    lp = str(tmp_path / "lpips.npz")
    write_synthetic_weights(lp)
    args = ["--cpu", "--output_dir", "run"]
    for o in TINY + ["train.eval_interval=1", "train.log_interval=1",
                     f"train.lpips_weights_path='{lp}'"]:
        args += ["--override", o]
    assert train_cli.main(args + ["--max_steps", "2"]) == 0
    for name in ("history.json", "config.json", "eval.csv", "best.json",
                 "train.log", "train/00000000_pred-rank0.png"):
        assert os.path.exists(os.path.join("run", name)), name
    assert ckpt_lib.latest_step("run/checkpoints") == 2
    assert ckpt_lib.latest_step("run/checkpoints_best") == 1
    assert train_cli.main(args + ["--only_eval", "--compare_with_input",
                                  "--eval_subdir", "final"]) == 0
    with open("eval.csv") as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["dataset", "psnr", "ssim", "lpips", "algo", "r",
                       "max mem"]
    assert len(rows) == 2 and rows[1][0] == "synthetic"
    assert all(np.isfinite(float(x)) for x in rows[1][1:4])
    assert rows[1][4:] == ["base", "0.0", "0.0"]
    assert os.path.exists("run/final/synthetic/metrics_input.rank0.json")
    assert train_cli.main(args + ["--only_eval", "--model", "ptv3_tome",
                                  "--merge_rate", "0.5"]) == 0
    with open("eval.csv") as f:
        rows = [line.strip().split(",") for line in f]
    assert len(rows) == 3 and rows[2][4:] == ["tome", "0.5", "0.0"]
    assert all(np.isfinite(float(x)) for x in rows[2][1:4])
    assert train_cli.main(args + ["--only_eval", "--save_viewer",
                                  "--eval_subdir", "viewer"]) == 0
    vdir = "run/viewer/synthetic/viewer/scene0"
    for f in ("cfg_args", "cameras.json", "viewer.html",
              "point_cloud/iteration_0/point_cloud.ply",
              "point_cloud/iteration_1/point_cloud.ply"):
        assert os.path.exists(os.path.join(vdir, f)), f
    if not torch.cuda.is_available():
        assert train_cli.main(["--output_dir", "run"]) == 1


def test_bench_on_cpu(monkeypatch, capsys):
    """The bench at 1024 Gaussians and 32^2 on the CPU, one timed
    iteration, with the tiny model in place of PTv3-base (at full width
    the CPU step takes seconds alone and minutes beside other test
    workers): the partial line, then the final line with bench.py's
    keys."""
    from splatformer_tpu_torch.configs import model_ptv3_base
    tiny = build_full_config(overrides=TINY).model
    monkeypatch.setattr(model_ptv3_base, "get_config", lambda: tiny)
    monkeypatch.setattr(bench, "ITERS", 1)
    assert bench.main(["1024", "32", "--cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2 and lines[0]["extra"]["partial"] is True
    final = lines[1]
    assert set(final) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert final["metric"] == "rasterize_fwd_bwd_mrays_per_s_per_chip"
    assert final["unit"] == "Mrays/s" and final["vs_baseline"] == 1.0
    assert "partial" not in final["extra"]
    extra = final["extra"]
    # value is Mrays/s = 4 views x 32^2 rays over the step, to 3 decimals
    ms = extra["measured_ms"]["rasterizer_fwd_bwd"]
    assert ms > 0 and abs(final["value"] - 4 * 32 * 32 / ms / 1e3) <= 5e-4
    assert extra["train_step_iters_per_s_per_chip"] > 0
    assert set(extra["measured_ms"]) == {"rasterizer_fwd_bwd", "train_step"}
    assert extra["config"] == {"n_gauss": 1024, "hw": 32, "views": 4,
                               "model": "ptv3_base bf16"}
    assert extra["device"]["platform"] == "cpu"
    assert np.isfinite(extra["train_step_metrics"]["total_loss"])
    if not torch.cuda.is_available():
        assert bench.main([]) == 1
