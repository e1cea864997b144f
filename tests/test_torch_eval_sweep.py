"""The merge-rate sweep (python -m splatformer_tpu_torch.eval_sweep) on the
CPU, torch only: a tiny run of the train CLI on synthetic scenes, then the
sweep over every algorithm at two rates from its checkpoint: the input and
base rows, one row a combination in eval.csv's schema, the base row equal
to --only_eval's PSNR of the same checkpoint, the rates past the merge cap
identical, a second call skipping what is done, and a failing combination
reported with exit status 1."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch import eval_sweep  # noqa: E402
from splatformer_tpu_torch import train as train_cli  # noqa: E402

TINY = [
    "dataset.n_scenes=2", "dataset.n_gaussians=256",
    "dataset.image_size=32", "dataset.image_per_scene=2",
    "model.backbone.enc_channels=(8, 16)", "model.backbone.dec_channels=(8,)",
    "model.backbone.enc_depths=(1, 1)", "model.backbone.enc_num_head=(1, 2)",
    "model.backbone.dec_depths=(1,)", "model.backbone.dec_num_head=(1,)",
    "model.backbone.stride=(2,)", "model.backbone.patch_size=16",
    "model.backbone.pool_capacity_factors=(1.0,)",
    "model.output_head_width=16", "model.output_head_nlayer=2",
    "model.grid_resolution=32", "model.zeroinit=False", "train.bf16=False",
    "train.lpips_weights_path=''",
]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def read(path):
    with open(path) as f:
        return [line.strip().split(",") for line in f]


def test_sweep_on_a_tiny_run(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    over = []
    for o in TINY + ["dataset.pad_to=256"]:
        over += ["--override", o]
    assert train_cli.main(["--cpu", "--output_dir", "run", "--max_steps",
                           "2"] + over) == 0
    assert train_cli.main(["--cpu", "--output_dir", "run", "--only_eval"]
                          + over) == 0
    only_eval_psnr = float(read("eval.csv")[1][1])

    sweep = ["--cpu", "--run", "run", "--dataset", "synthetic", "--pad",
             "256", "--csv", "out/sweep.csv", "--rates", "0.5,0.9"]
    for o in TINY:
        sweep += ["--override", o]
    assert eval_sweep.main(sweep) == 0
    rows = read("out/sweep.csv")
    assert rows[0] == ["dataset", "psnr", "ssim", "lpips", "algo", "r",
                       "max mem"]
    algos = (eval_sweep.MERGE_ALGOS + eval_sweep.TOMESD_ALGOS
             + eval_sweep.DOWN_ALGOS)
    assert len(algos) == 13 and len(rows) == 1 + 2 + 2 * 13
    by = {(r[4], r[5]): [float(x) for x in r[1:3]] for r in rows[1:]}
    assert all(r[0] == "synthetic-pad256" for r in rows[1:])
    assert all(np.isfinite(v).all() for v in by.values())
    assert abs(by[("base", "0.0")][0] - only_eval_psnr) <= 1e-3
    assert by[("base", "0.0")] != by[("input", "0.0")]
    # r = 0.5 and 0.9 both merge the capped K // 2
    for algo in ("tome", "pitome", "tofu", "prune", "patch", "wpatch"):
        assert by[(algo, "0.5")] == by[(algo, "0.9")], algo
    assert by[("fps", "0.5")] != by[("fps", "0.9")]
    out = capsys.readouterr().out
    assert out.count('"fps_ms"') == 2 and "sweep complete" in out

    # done rows are skipped; an unknown algorithm fails the process
    assert eval_sweep.main(sweep + ["--algos", "tome,no_such"]) == 1
    assert len(read("out/sweep.csv")) == len(rows)
    err = capsys.readouterr().err
    assert "FAILED no_such r=0.5" in err and "2 combinations failed" in err
