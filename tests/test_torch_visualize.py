"""The port's visualizer (``python -m splatformer_tpu_torch.visualize``)
against the repo-root visualize.py on the CPU at a tiny size (the tiny
backbone of tests/test_torch_flops.py, its overrides added to both
packages' build_full_config, 64 Gaussians, base and ToMe, the first and
the last block). The port's models load the JAX visualizer's initialised
variables (data/convert.py), so both replay the same weights on the same
scene: the same file names, every PLY's coordinates equal to the JAX
file's and its colours within one uint8 step (the PCA, ``diff_*`` and
``merge_*`` colourings), PLYs with one vertex a point (half the tokens for
a merged cloud without trace_back), an index.html linking every cloud and
a viewer.html holding them. The JAX model's init and apply are jitted here
(eagerly, the CPU compiles each of their ~900 operations alone)."""
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import splatformer_tpu.configs as jax_configs  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
import splatformer_tpu_torch.configs as port_configs  # noqa: E402
import splatformer_tpu_torch.models.feature_predictor as port_fp  # noqa: E402
from splatformer_tpu_torch import visualize  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.utils.viewer import read_ply  # noqa: E402
from test_torch_flops import TINY  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_visualize_writes_the_jax_files(tmp_path, monkeypatch):
    args = ["--cpu", "--n_gaussians", "64", "--algos", "base", "tome",
            "--blocks", "enc0_block0", "dec0"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_visualize", os.path.join(root, "visualize.py"))
    jax_visualize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_visualize)
    build = jax_configs.build_full_config
    build_port = port_configs.build_full_config
    init, apply = JaxFP.init, JaxFP.apply
    inits = []   # the JAX visualizer's variables, one an algorithm

    def jax_init(self, key, scene, train):
        v = jax.jit(lambda k, s: init(self, k, s, train))(key, scene)
        inits.append(jax.tree.map(np.asarray, jax.device_get(v)))
        return v

    monkeypatch.setattr(JaxFP, "init", jax_init)
    monkeypatch.setattr(
        JaxFP, "apply", lambda self, v, scene, train, **kw: jax.jit(
            lambda v, s: apply(self, v, s, train, **kw))(v, scene))
    monkeypatch.setattr(
        jax_configs, "build_full_config",
        lambda *a, **k: build(*a, **k, overrides=TINY))
    monkeypatch.setattr(
        port_configs, "build_full_config",
        lambda *a, **k: build_port(*a, **k, overrides=TINY))
    monkeypatch.setattr(sys, "argv", ["visualize.py", *args, "--out",
                                      str(tmp_path / "j")])
    jax_visualize.main()
    assert len(inits) == 2
    build_model = port_fp.build_feature_predictor

    def build_on_jax_weights(*a, **k):
        model = build_model(*a, **k)
        v = inits.pop(0)
        model.load_state_dict(state_dict_from_flax(
            v["params"], v.get("batch_stats")), strict=True)
        return model

    monkeypatch.setattr(port_fp, "build_feature_predictor",
                        build_on_jax_weights)
    assert visualize.main(args + ["--out", str(tmp_path / "t")]) == 0
    got = sorted(os.listdir(tmp_path / "t"))
    assert got == sorted(os.listdir(tmp_path / "j"))
    # 2 blocks x 2 heads: base and tome clouds, tome's diff and merge
    plys = [f for f in got if f.endswith(".ply")]
    assert len(plys) == 16 and "index.html" in got and "viewer.html" in got
    for f in plys:
        ply, want = (read_ply(str(tmp_path / d / f)) for d in ("t", "j"))
        assert list(ply) == list(want) == ["x", "y", "z", "red", "green",
                                          "blue"], f
        for k in ("x", "y", "z"):
            np.testing.assert_array_equal(ply[k], want[k], err_msg=f)
        for k in ("red", "green", "blue"):
            np.testing.assert_allclose(ply[k], want[k], rtol=0,
                                       atol=1.0 / 255 + 1e-7, err_msg=f)
        n = len(ply["x"])
        if f.startswith("merge_"):   # ToMe at r 0.5: half the tokens
            assert 2 * n == len(read_ply(str(
                tmp_path / "t" / f.replace("merge_tome", "base")))["x"])
        else:
            assert n == 64
    html = (tmp_path / "t" / "viewer.html").read_text()
    assert all(f[:-4] in html for f in plys)
    index = (tmp_path / "t" / "index.html").read_text()
    assert all(f"href='{f}'" in index for f in plys)
