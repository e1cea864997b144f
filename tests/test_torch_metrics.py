"""The port's MetricComputer (training/metrics.py) against the JAX
package's, live, on the same images and the same LPIPS weights file: the
per-image values, the rescaling of 0-255 images, update_value, sum,
finalize and the JSON layout. Also holds the JAX values that the torch-only
tests/test_torch_checkpoint_metrics.py keeps as constants."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.models.lpips import make_lpips_fn as jax_lpips_fn  # noqa: E402
from splatformer_tpu.training.metrics import (  # noqa: E402
    MetricComputer as JaxMetricComputer)
from splatformer_tpu_torch.models.lpips import (make_lpips_fn,  # noqa: E402
                                                write_synthetic_weights)
from splatformer_tpu_torch.training.metrics import MetricComputer  # noqa: E402
from tests.test_torch_checkpoint_metrics import (JAX_FINAL,  # noqa: E402
                                                 JAX_RESULTS, JAX_SUM,
                                                 metric_inputs)

TOL = {"psnr": 1e-4, "ssim": 1e-5, "lpips": 1e-5, "input_psnr": 0}


@pytest.fixture(scope="module")
def computers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    write_synthetic_weights(path)
    jmc = JaxMetricComputer(jax_lpips_fn(path))
    pmc = MetricComputer(make_lpips_fn(path, device="cpu"))
    for name, pred, gt in metric_inputs():
        jmc.update(jnp.asarray(pred.numpy()), jnp.asarray(gt.numpy()), name)
        pmc.update(pred, gt, name)
    for mc in (jmc, pmc):
        mc.update_value("input_psnr", 21.5, "a")
    return jmc, pmc


def written(mc, path):
    mc.write_to_file(str(path))
    with open(path) as f:
        return json.load(f)


def test_metric_computer_matches_jax_live(computers, tmp_path):
    """Per image within 1e-4 dB PSNR and 1e-5 SSIM and LPIPS; the same
    keys, sums, means and JSON layout."""
    jmc, pmc = computers
    jw, pw = written(jmc, tmp_path / "j.json"), written(pmc, tmp_path / "p.json")
    assert pw == pmc.results_dict
    assert list(pw) == list(jw) == ["a", "b"]
    for name in jw:
        assert list(pw[name]) == list(jw[name])
        for k, v in jw[name].items():
            np.testing.assert_allclose(pw[name][k], v, rtol=0, atol=TOL[k],
                                       err_msg=f"{name} {k}")
    for got, ref in ((pmc.finalize(), jmc.finalize()),
                     (pmc.sum(), jmc.sum())):
        assert list(got) == list(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 4 * TOL[k] + 1e-12, k


def test_stored_jax_values_are_current(computers):
    """The constants of tests/test_torch_checkpoint_metrics.py are what the
    JAX package computes now."""
    jmc, _ = computers
    assert jmc.results_dict.keys() == JAX_RESULTS.keys()
    for name, ref in JAX_RESULTS.items():
        assert jmc.results_dict[name].keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(jmc.results_dict[name][k], v,
                                       rtol=1e-6, err_msg=f"{name} {k}")
    for got, ref in ((jmc.finalize(), JAX_FINAL), (jmc.sum(), JAX_SUM)):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-6), k
