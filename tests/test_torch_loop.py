"""The port's training loop (training/loop.py) against the JAX package's
run_training on the CPU: the tiny configuration of
tests/test_orchestration.py (f32, drop_path 0, LPIPS from the seeded synthetic
weights of models/lpips.py) trained with SGD on a 1-device mesh, the order shuffle fixed in
both as in tests/test_torch_train_step.py.

Both loops start from the same weights without a switch in either: the JAX
package's initial variables, made as its run_training makes them (the
model's init from ``train.seed`` on the first training scene), are
converted by data/convert.py and saved with the port's own save_checkpoint
at step 0 in the port run's ``checkpoints/``, which the port's run_training
then restores. One JAX run_training, in one module-scoped fixture."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.configs import build_full_config as jax_full_config  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.parallel.mesh import make_mesh  # noqa: E402
from splatformer_tpu.training import loop as jloop  # noqa: E402
from splatformer_tpu_torch.configs import build_full_config  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    build_feature_predictor)
from splatformer_tpu_torch.models.lpips import write_synthetic_weights  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training import checkpoints as ckpt_lib  # noqa: E402
from splatformer_tpu_torch.training import loop  # noqa: E402

STEPS = 3
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
                "features_rest", "mask")
ORDER_PERM = (2, 0, 3, 1)
# tests/test_orchestration.py:37-71, with SGD (after the 2.0 clip each
# update is the gradient itself; Adam at eps 1e-15 would turn rounding-size
# gradients into full steps of opposite sign) at lr 2e-4: a step moves the
# loss by ~5%, while the two frameworks' updates, ~1e-3 apart relative to
# the update (tests/test_torch_train_step.py), keep the logged metrics
# within 3e-5 of each other over 5 steps (at 3e-4 the LPIPS term drifts
# 1.1e-4 apart, at 1e-3 the loss 5e-4 by step 2). One eval, at step 2, and
# no train renders (test_train_cli_on_cpu writes one): each compiles
# another JAX program.
OVERRIDES = [
    "dataset.n_scenes=2", "dataset.n_gaussians=256", "dataset.pad_to=256",
    "dataset.max_gs_num=256", "dataset.image_size=32",
    "dataset.image_per_scene=2",
    "model.backbone.enc_channels=(8, 16)", "model.backbone.dec_channels=(8,)",
    "model.backbone.enc_depths=(1, 1)", "model.backbone.enc_num_head=(1, 2)",
    "model.backbone.dec_depths=(1,)", "model.backbone.dec_num_head=(1,)",
    "model.backbone.stride=(2,)", "model.backbone.patch_size=16",
    "model.backbone.drop_path=0.0", "model.backbone.pool_capacity_factors=(1.0,)",
    "model.output_head_width=16", "model.output_head_nlayer=2",
    "model.grid_resolution=32",
    "train.log_interval=1", "train.eval_interval=2", "train.save_interval=100",
    "train.log_image_interval=0", "train.bf16=False",
    "train.lpips_loss_weight=1.0", "train.optimizer.type='sgd'",
    "train.optimizer.lr_dict.base=2e-4", "train.optimizer.lr_dict.backbone=2e-4",
]


def read_csv(path):
    with open(path) as f:
        return [line.strip().split(",") for line in f if line.strip()]


def read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    lpips_path = str(tmp / "lpips_vgg.npz")
    write_synthetic_weights(lpips_path)
    overrides = OVERRIDES + [f"train.lpips_weights_path='{lpips_path}'"]
    jcfg = jax_full_config("ptv3_base", "synthetic", "default", overrides)
    pcfg = build_full_config("ptv3_base", "synthetic", "default", overrides)
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")

    # the JAX initial variables, as run_training makes them (:384-399), on
    # its first training scene (the port's copy of it: test_same_synthetic_
    # pairs holds the two equal)
    jmodel = jloop.build_feature_predictor(jcfg.model, bn_axis_name="data")
    ptrain, _ = loop.make_synthetic_data(pcfg.dataset, RasterizeConfig(),
                                         "cpu")
    first = next(ptrain).scene
    scene0 = JaxScene(**{k: jnp.asarray(getattr(first, k).numpy())
                         for k in SCENE_FIELDS})
    variables = jax.device_get(jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(jcfg.train.seed), scene0))
    model = build_feature_predictor(pcfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]))
    ckpt_lib.save_checkpoint(os.path.join(pdir, "checkpoints"),
                             loop.build_train_state(pcfg, model, "cpu"), 0)

    # jax.random streams cannot be reproduced in torch: fix both shuffles
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(ORDER_PERM, jnp.int32))
    mp.setattr(torch, "randperm",
               lambda n, *a, generator=None, device=None, **k: torch.tensor(
                   ORDER_PERM, device=device))
    try:
        jres = jloop.run_training(jcfg, jdir, mesh=make_mesh(n_devices=1),
                                  max_steps=STEPS)
        pres = loop.run_training(pcfg, pdir, max_steps=STEPS, device="cpu")
    finally:
        mp.undo()
    # read now: the resume test trains on in the port's directory
    files = {(side, name): (read_json if name.endswith(".json") else
                            read_csv)(os.path.join(d, name))
             for side, d in (("jax", jdir), ("port", pdir))
             for name in ("history.json", "eval.csv", "best.json")}
    return dict(jcfg=jcfg, pcfg=pcfg, jdir=jdir, pdir=pdir, jres=jres,
                pres=pres, files=files)


@pytest.mark.parametrize("pad_to", [256, 320])
def test_same_synthetic_pairs(runs, pad_to):
    """Scene attributes exact, ground truth within 1e-5 (two renderers).
    The JAX package's synthetic scenes are not padded; with ``pad_to``
    above ``n_gaussians`` the port's live rows are still its rows, and the
    slots after them masked zeros."""
    _, ptest = loop.make_synthetic_data(
        dataclasses.replace(runs["pcfg"].dataset, pad_to=pad_to),
        RasterizeConfig(), "cpu")
    jscenes = runs["jres"][3]["synthetic"]()
    pscenes = ptest["synthetic"]()
    assert [n for n, _ in jscenes] == [n for n, _ in pscenes] == [
        "scene0", "scene1"]
    n = runs["pcfg"].dataset.n_gaussians
    for (_, jb), (_, pb) in zip(jscenes, pscenes):
        assert pb.scene.num_points == pad_to
        for k in SCENE_FIELDS:
            got = getattr(pb.scene, k).numpy()
            np.testing.assert_array_equal(
                got[:n], np.asarray(getattr(jb.scene, k)), err_msg=k)
            assert not got[n:].any(), k
        np.testing.assert_array_equal(pb.cameras.c2w.numpy(),
                                      np.asarray(jb.cameras.c2w))
        np.testing.assert_allclose(pb.images.numpy(), np.asarray(jb.images),
                                   rtol=0, atol=1e-5)


def test_same_calibrated_raster_config(runs):
    jr, pr = runs["jres"][4], runs["pres"][3]
    assert (pr.tiers, pr.tiles_per_gauss, pr.max_intersects) == (
        tuple(jr.tiers), jr.tiles_per_gauss, jr.max_intersects)


def test_history_losses_match(runs):
    """Every logged step's metrics within 1e-4 relative."""
    jh, ph = (runs["files"][s, "history.json"] for s in ("jax", "port"))
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == list(
        range(STEPS))
    for j, p in zip(jh, ph):
        assert set(p) == set(j) == {
            "step", "total_loss", "image_l1", "lpips", "train_psnr",
            "num_dropped", "steps_per_s"}
        for k in ("total_loss", "image_l1", "lpips", "train_psnr"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
        assert p["num_dropped"] == j["num_dropped"] == 0
    # the loop applied its updates: scene0's loss moved between its steps
    assert abs(ph[2]["total_loss"] / ph[0]["total_loss"] - 1) > 1e-2


def test_eval_csv_matches(runs):
    """Run-local eval.csv: the same header and steps; PSNR within 1e-3 dB,
    SSIM and LPIPS within 1e-4, refined and input."""
    jrows, prows = (runs["files"][s, "eval.csv"] for s in ("jax", "port"))
    assert prows[0] == jrows[0] == loop.RUN_EVAL_CSV_HEADER.strip().split(",")
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert [r[1] for r in prows[1:]] == ["2"]
    for j, p in zip(jrows[1:], prows[1:]):
        for col, tol in zip(range(2, 8), (1e-3, 1e-4, 1e-4) * 2):
            assert abs(float(p[col]) - float(j[col])) <= tol, (
                jrows[0][col], p[col], j[col])


def test_checkpoints_best_and_resume(runs):
    """As the JAX smoke test: the final save at the last step, best.json
    and checkpoints_best at the best eval, the metric JSONs written; a second call resumes at the stored step and trains
    no further, a call with more steps continues from it."""
    jdir, pdir = runs["jdir"], runs["pdir"]
    from splatformer_tpu.training import checkpoints as jckpt
    state = runs["pres"][0]
    assert state.step == STEPS
    assert ckpt_lib.latest_step(os.path.join(pdir, "checkpoints")) == (
        jckpt.latest_step(os.path.join(jdir, "checkpoints"))) == STEPS
    jbest, pbest = (runs["files"][s, "best.json"] for s in ("jax", "port"))
    assert pbest["step"] == jbest["step"]
    assert abs(pbest["psnr"] - jbest["psnr"]) <= 1e-3
    assert ckpt_lib.latest_step(os.path.join(pdir, "checkpoints_best")) == (
        pbest["step"])
    for sub in ("eval/synthetic/2/metrics.rank0.json",
                "eval/synthetic/2/metrics_input.rank0.json", "config.json"):
        assert os.path.exists(os.path.join(pdir, sub)), sub
    metrics = read_json(os.path.join(pdir, "eval/synthetic/2/metrics.rank0.json"))
    assert sorted(metrics) == ["scene0", "scene1"]
    assert all(np.isfinite(s["lpips"]).all() for s in metrics.values())

    again = loop.run_training(runs["pcfg"], pdir, max_steps=STEPS,
                              device="cpu")[0]
    assert again.step == STEPS
    more = loop.run_training(runs["pcfg"], pdir, max_steps=STEPS + 1,
                             device="cpu")[0]
    assert more.step == STEPS + 1
    hist = read_json(os.path.join(pdir, "history.json"))
    assert [h["step"] for h in hist] == [STEPS]
    assert read_json(os.path.join(pdir, "best.json")) == pbest
