"""A tiny version of a cell for the CPU tests: PTv3 with three stages at
the head widths K3 takes (16, 24, 32), patch 128, 2,048 Gaussians, views of
64 x 64."""
from __future__ import annotations

import copy
from typing import Dict

from perfbench.lib import harness

TINY_BACKBONE = dict(
    enc_depths=[1, 1, 1], enc_channels=[32, 48, 64], enc_num_head=[2, 2, 2],
    dec_depths=[1, 1], dec_channels=[32, 48], dec_num_head=[2, 2],
    stride=[1, 2], pool_capacity_factors=[1.0, 0.75], patch_size=128)


def tiny_cell(workload: str, **traffic) -> Dict:
    """The cell as BENCHMARK.json defines it, cut to the tiny sizes."""
    cell = copy.deepcopy(harness.load_cell(harness.load_benchmark(),
                                           workload))
    cell["config"]["model"]["backbone"].update(TINY_BACKBONE)
    cell["config"]["scene"].update(pad_to=2048, n_valid_min=1200,
                                   n_valid_max=2000)
    cell["traffic"].update(views=2, height=64, width=64, pool=4,
                           **traffic)
    if "recipe" in cell["traffic"]:
        cell["traffic"]["recipe"]["lpips_loss_weight"] = 1.0
    return cell
