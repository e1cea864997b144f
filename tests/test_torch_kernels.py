"""The port's CUDA kernels on the card against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs where
JAX is not installed. On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(--noconftest skips tests/conftest.py, which sets up JAX). Without a card
the `cuda` tests skip; the build bookkeeping is checked everywhere.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from splatformer_tpu_torch.kernels.build import (BUILD_DIR, SOURCES,  # noqa: E402
                                                 library_path)


def test_every_kernel_has_a_source_and_a_counter():
    for name, src in SOURCES.items():
        path = library_path(name)
        assert path.parent == BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == library_path(name)  # named by content, stable
        assert name in LAUNCHES
    reset_launches()
    assert set(LAUNCHES.values()) == {0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_composite_kernel_matches_plain_on_card():
    """K1 on the card vs its plain version on the same CUDA inputs: outputs
    within 1e-5, walked counts exact, one counted launch."""
    _card()
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(0), 20_000, sh_degree=1)
    cams = orbit_cameras(4, 128, 128)
    e = prepare_entries(scene, cams, RasterizeConfig())
    before = LAUNCHES["composite_fwd"]
    out_k, walked_k = composite_fwd(e.packed_t, e.tile_start, 8, 64)
    torch.cuda.synchronize()
    assert LAUNCHES["composite_fwd"] == before + 1
    out_p, walked_p = composite_fwd_plain(e.packed_t, e.tile_start, 8, 64)
    assert float((out_k - out_p).abs().max()) <= 1e-5
    assert torch.equal(walked_k, walked_p)
    assert float(out_k[..., 3].min()) < 0.5  # it really composited


@pytest.mark.cuda
def test_composite_kernel_empty_and_ragged_tiles():
    """Tiles with no entries, and ranges that are not multiples of the
    kernel's 256-entry staging batch."""
    _card()
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    rng = np.random.default_rng(1)
    budget = 1300
    packed = np.zeros((16, budget), np.float32)
    packed[0:2] = rng.uniform(0, 32, (2, budget))
    packed[2] = packed[4] = rng.uniform(0.05, 0.5, budget)
    packed[3] = rng.uniform(-0.02, 0.02, budget)
    packed[5] = rng.uniform(0.0, 0.9, budget)
    packed[6:9] = rng.uniform(0, 1, (3, budget))
    tile_start = np.array([0, 0, 257, 900, 1300], np.int32)
    args = (torch.from_numpy(packed).cuda(), torch.from_numpy(tile_start).cuda(),
            2, 4)
    out_k, walked_k = composite_fwd(*args)
    out_p, walked_p = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= 1e-5
    assert torch.equal(walked_k, walked_p)
    assert torch.all(out_k[0, :, 3] == 1.0) and torch.all(walked_k[0] == 0)
