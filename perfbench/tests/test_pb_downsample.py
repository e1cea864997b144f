"""reference/downsample.py and the reference's refine with input
downsampling against the port's plain paths on the CPU, bit for bit: FPS
is chaotic, so the reference's arithmetic is what defines the right
picks."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from perfbench.lib import program, scenes, weights
from perfbench.reference import downsample as ref_ds
from perfbench.reference import steps as reference
from perfbench.tests.tiny import tiny_cell
from splatformer_tpu_torch.ops import downsample as port_ds

INFOS = {"fps": {"downsample": "fps", "downsample_ratio": 0.35},
         "voxel": {"downsample": "voxel", "voxel_size": 0.0075},
         "random": {"downsample": "random", "downsample_ratio": 0.6}}


def points(n: int, n_valid: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    coord = torch.as_tensor(rng.uniform(0.05, 0.95, (n, 3)),
                            dtype=torch.float32)
    feat = torch.as_tensor(rng.normal(size=(n, 5)), dtype=torch.float32)
    mask = torch.arange(n) < n_valid
    return coord, feat, mask


@pytest.mark.parametrize("method", list(INFOS))
def test_downsampling_equals_the_programs(method):
    """Each method's reduced set and its map back, in evaluation (random:
    the CPU generator seeded 0), equal the port's bit for bit."""
    coord, feat, mask = points(1536, 1400)
    y_seed = torch.Generator().manual_seed(5)
    got = ref_ds.downsample_dispatch(method, INFOS[method], coord, feat, mask)
    want = port_ds.downsample_dispatch(method, INFOS[method], coord, feat,
                                       mask)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    y = torch.randn(got[0].shape[0], 7, generator=y_seed)
    assert torch.equal(got[3](y), want[3](y))
    assert got[0].shape[0] == ref_ds.backbone_rows(INFOS[method], 1536)


def test_fps_picks_equal_the_programs():
    coord, _, mask = points(4096, 3000, seed=11)
    m = int(4096 * 0.35)
    assert torch.equal(ref_ds.furthest_point_sampling(coord, mask, m),
                       port_ds.furthest_point_sampling(coord, mask, m))


def fps_cell(flash: bool):
    cell = copy.deepcopy(tiny_cell("serve_flash"))
    model = cell["config"]["model"]
    model["additional_info"].update(INFOS["fps"])
    model["backbone"]["enable_flash"] = flash
    return cell


def test_refine_with_fps_equals_the_programs():
    """The reference's whole refine with ``downsample: fps`` and the
    program's eval-mode refine, from the same seeded weights and scene, at
    the plain attention (K3's plain version rounds apart from the
    reference's softmax, with or without downsampling)."""
    cell = fps_cell(False)
    model, sc = cell["config"]["model"], cell["config"]["scene"]
    seed = 2 ** 31 + 9
    noisy = scenes.make_pool(seed, sc, 1, 0.004, "cpu")[0]["noisy"]

    def state(m):
        return weights.model_state(weights.shapes(m), seed, "cpu",
                                   cell["config"]["weights"][
                                       "head_final_scale"],
                                   model["output_head_nlayer"])
    prog = program.build_model(model, "cpu")
    weights.load(prog, state(prog))
    with torch.inference_mode():
        got = prog(program.scene(noisy))
    ref = reference.build_model(model, "cpu")
    weights.load(ref, state(ref))
    want = reference.refine(ref, noisy)
    moved = 0.0
    for k, w in want.items():
        assert torch.equal(getattr(got, k), w), k
        moved = max(moved, float((w - noisy[k]).abs().max()))
    assert moved > 0
