"""Attention capture and the per-head replay (utils/attn_replay.py) against
the JAX package's on the CPU, same weights and scene (the pair helper of
tests/test_torch_diagnostics.py): the captured records equal JAX
``collect_attention_blocks``'s (the same paths in the same order, order and
inverse exactly, input and output within 1e-5); ``replay_model`` equals
JAX's for no merging, ToMe and ALGM, with ``trace_back`` on and off
(features within rtol 1e-4 and atol 1e-5; colours, ``size`` and
``n_effective_tokens`` exactly, merged coordinates within 1e-6). Then the
four properties of tests/test_attn_replay.py on the port alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


from splatformer_tpu.utils import attn_replay as jax_replay  # noqa: E402
from splatformer_tpu_torch.utils import attn_replay  # noqa: E402
from test_torch_diagnostics import (ALGM, BK, TOME, jax_scene, pair,  # noqa: E402
                                    port_scene)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


INFOS = {"none": None, "tome": TOME, "algm": ALGM}


@pytest.mark.parametrize("case", sorted(INFOS))
def test_capture_matches_jax_collect(case):
    jmodel, variables, tmodel = pair(INFOS[case])
    scene = jax_scene()
    want = jax_replay.collect_attention_blocks(jmodel, variables, scene)
    got = attn_replay.collect_attention_blocks(tmodel, port_scene(scene))
    assert list(got) == list(want) and len(got) == 3
    for path, rec in got.items():
        for k in ("attn_order", "attn_inverse", "attn_coord"):
            np.testing.assert_array_equal(rec[k].numpy(), want[path][k],
                                          err_msg=f"{path} {k}")
        for k in ("attn_in", "attn_feat"):
            np.testing.assert_allclose(rec[k].numpy(), want[path][k], rtol=0,
                                       atol=1e-5, err_msg=f"{path} {k}")
        np.testing.assert_array_equal(rec["qkv_kernel"].numpy(),
                                      want[path]["qkv_kernel"])
        np.testing.assert_array_equal(rec["qkv_bias"].numpy(),
                                      want[path]["qkv_bias"])


@pytest.mark.parametrize("trace_back", [False, True])
@pytest.mark.parametrize("case", sorted(INFOS))
def test_replay_matches_jax(case, trace_back):
    info = dict(INFOS[case] or {}, trace_back=trace_back)
    jmodel, variables, tmodel = pair(info)
    scene = jax_scene()
    want = jax_replay.replay_model(jmodel, variables, scene, BK, 16,
                                   additional_info=info)
    got = attn_replay.replay_model(tmodel, port_scene(scene), BK, 16,
                                   additional_info=info)
    assert list(got) == list(want)
    for path, rep in got.items():
        ref = want[path]
        assert rep["n_tokens"] == ref["n_tokens"]
        assert rep["n_effective_tokens"] == ref["n_effective_tokens"]
        if ref["size"] is None:
            assert rep["size"] is None
        else:
            np.testing.assert_array_equal(rep["size"], ref["size"])
        np.testing.assert_array_equal(rep["coord"], ref["coord"])
        for k in ("attn_feats", "ori_attn_feats"):
            for a, b in zip(rep[k], ref[k], strict=True):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{path} {k}")
        if ref["merged_colors"] is None:
            assert rep["merged_colors"] is None
        else:
            for a, b in zip(rep["merged_colors"], ref["merged_colors"],
                            strict=True):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(rep["merged_coords"], ref["merged_coords"],
                        strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _replay_base_equals_ori(tmodel, scene, info):
    for rep in attn_replay.replay_model(tmodel, scene, BK, 16).values():
        for a, b in zip(rep["attn_feats"], rep["ori_attn_feats"]):
            np.testing.assert_array_equal(a, b)
        assert rep["size"] is None
        assert rep["n_effective_tokens"] == rep["n_tokens"]


def _replay_matches_module(tmodel, scene, info):
    """The recorded attn_feat equals the per-head replay concatenated over
    heads."""
    recs = attn_replay.collect_attention_blocks(tmodel, scene)
    replays = attn_replay.replay_model(tmodel, scene, BK, 16,
                                       additional_info=info)
    assert replays
    for path, rep in replays.items():
        stacked = np.concatenate(rep["attn_feats"], axis=1)
        np.testing.assert_allclose(stacked, recs[path]["attn_feat"].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _trace_back_colours_original_points(tmodel, scene, info):
    for rep in attn_replay.replay_model(tmodel, scene, BK, 16,
                                        additional_info=info).values():
        n = rep["n_tokens"]
        assert rep["n_effective_tokens"] < n
        for hi in range(len(rep["merged_colors"])):
            assert rep["merged_colors"][hi].shape == (n, 3)
            assert rep["merged_coords"][hi].shape == (n, 3)
        # merge groups: at least one colour appears on >= 2 points
        _, counts = np.unique(np.round(rep["merged_colors"][0], 6), axis=0,
                              return_counts=True)
        assert counts.max() >= 2


def _no_trace_back_reports_merged_tokens(tmodel, scene, info):
    for rep in attn_replay.replay_model(tmodel, scene, BK, 16,
                                        additional_info=info).values():
        for hi in range(len(rep["merged_colors"])):
            assert rep["merged_colors"][hi].shape[0] < rep["n_tokens"]


PROPERTIES = {
    "base_equals_ori": (_replay_base_equals_ori, None),
    "matches_module_none": (_replay_matches_module, None),
    "matches_module_tome": (_replay_matches_module, TOME),
    "matches_module_algm": (_replay_matches_module, ALGM),
    "trace_back": (_trace_back_colours_original_points,
                   dict(TOME, trace_back=True)),
    "no_trace_back": (_no_trace_back_reports_merged_tokens,
                      dict(TOME, trace_back=False)),
}


@pytest.mark.parametrize("name", sorted(PROPERTIES))
def test_replay_properties(name):
    """tests/test_attn_replay.py's properties, on the port's own seeded
    weights."""
    from splatformer_tpu_torch.models.feature_predictor import (
        FeaturePredictor, init_weights)
    from test_torch_diagnostics import MODEL_KW
    check, info = PROPERTIES[name]
    tmodel = FeaturePredictor(additional_info=info, backbone_kwargs=BK,
                              **MODEL_KW).eval()
    init_weights(tmodel, torch.Generator().manual_seed(0))
    check(tmodel, port_scene(jax_scene()), info)
