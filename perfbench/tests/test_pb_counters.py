"""The harness's counters against the program's own arithmetic: the
frozen attention + MLP count against utils/flops.py, the mfu count
against a hand count, K3's bound against the kernel table's numbers."""
from __future__ import annotations

import pytest

from perfbench.lib import counters
from perfbench.reference.steps import backbone_kwargs, head_channels
from perfbench.tests.tiny import tiny_cell
from splatformer_tpu_torch.configs import load_config
from splatformer_tpu_torch.utils import flops as port_flops

# the kernel table's per-forward bounds (PERF.md; chip_smoke.py's k3 and
# k3_bwd lines): ms, f32 and bf16, forward and backward
K3_TABLE_MS = {(False, False): 5.79, (False, True): 14.47,
               (True, False): 3.18, (True, True): 3.22}
K3_CLASSES = {"enc0": (98, 2, 32, 2), "enc1_dec1_dec0": (98, 4, 24, 6),
              "enc2_dec2": (74, 8, 16, 4), "enc3_dec3": (47, 16, 16, 8),
              "enc4": (24, 32, 16, 2)}
STAGES = {"enc0": 100000.0, "enc1": 71234.0, "enc2": 40321.0,
          "enc3": 19876.0, "enc4": 8123.0, "dec0": 100000.0,
          "dec1": 71234.0, "dec2": 40321.0, "dec3": 19876.0}


def base_flash():
    return tiny_cell("serve_flash")


@pytest.mark.parametrize("model", ["ptv3_base", "ptv3_tome", "ptv3_pitome",
                                   "ptv3_algm"])
@pytest.mark.parametrize("flash", [False, True])
def test_attention_mlp_count_equals_the_programs(model, flash):
    cfg = load_config("model", model)
    cfg.backbone.enable_flash = flash
    bk = cfg.backbone.backbone_kwargs()
    info = cfg.additional_info
    assert counters.ptv3_attention_mlp_gflops(bk, STAGES, info) == \
        port_flops.ptv3_attention_mlp_gflops(bk, STAGES, info)


def test_k3_calls_are_the_kernel_tables_classes():
    cfg = load_config("model", "ptv3_base")
    cfg.backbone.enable_flash = True
    calls = counters.k3_calls(cfg.backbone.backbone_kwargs(), 100352)
    want = []
    for b, h, d, blocks in K3_CLASSES.values():
        want += [(b, h, d)] * blocks
    assert sorted(calls) == sorted(want) and len(calls) == 22


@pytest.mark.parametrize("bf16,backward", list(K3_TABLE_MS))
def test_k3_bound_reproduces_the_kernel_table(bf16, backward):
    ops = sum(blocks * counters.k3_bound(b, h, d, bf16, backward)[0]
              for b, h, d, blocks in K3_CLASSES.values())
    nbytes = sum(blocks * counters.k3_bound(b, h, d, bf16, backward)[1]
                 for b, h, d, blocks in K3_CLASSES.values())
    assert round(max(ops, nbytes) * 1e3, 2) == K3_TABLE_MS[(bf16, backward)]
    # every call is bound by its operations, so the per-call sum the
    # roofline metrics use is the table's number too
    cfg = load_config("model", "ptv3_base")
    cfg.backbone.enable_flash = True
    per_call = counters.k3_forward_bound_s(cfg.backbone.backbone_kwargs(),
                                           100352, bf16, backward)
    assert round(per_call * 1e3, 2) == K3_TABLE_MS[(bf16, backward)]


def hand_count(points, pairs, tokens_mlp):
    """The tiny configuration's forward FLOPs counted by hand, two a
    multiply-add: 3 encoder stages of one block (32, 48, 64 channels, 2
    heads, patch 128) and 2 decoder stages of one block (32, 48), each
    block qkv + proj (4 n c^2), the xCPE convolution (pairs c^2) and Linear
    (n c^2), the MLP (2 n c 4c) and the two attention products; the
    embedding (23 inputs), two poolings, two unpoolings (projection and
    skip), and six heads of 4 layers of width 128 on 32 + 23 inputs."""
    enc, dec = [32, 48, 64], [32, 48, 64]
    blocks = [(0, 32), (1, 48), (2, 64), (0, 32), (1, 48)]
    dense = attn = 0.0
    for s, c in blocks:
        n = points[s]
        dense += 2 * (4 * n * c * c + pairs[s] * c * c + n * c * c
                      + 2 * tokens_mlp(n) * c * 4 * c)
        attn += 2 * 2 * max(1.0, n / 128) * 2 * 128 * 128 * (c // 2)
    in_ch = 3 + 3 + 1 + 4 + 3 + 9
    outside = 2 * points[0] * in_ch * 32
    outside += 2 * (points[0] * 32 * 48 + points[1] * 48 * 64)
    outside += 2 * (points[1] * 48 * 32 + points[0] * 32 * 32)
    outside += 2 * (points[2] * 64 * 48 + points[1] * 48 * 48)
    head_in = 32 + in_ch
    for out in (3, 3, 1, 4, 3, 9):
        outside += 2 * points[0] * (head_in * 128 + 2 * 128 * 128 + 128 * out)
    return {"block_dense": dense, "outside_dense": outside,
            "attn_products": attn}


def test_mfu_count_equals_a_hand_count():
    model = base_flash()["config"]["model"]
    bk = backbone_kwargs(model["backbone"])
    points = [2000.0, 1300.0, 700.0]
    pairs = [9000.0, 5000.0, 2500.0]
    sp = {"enc0": 2000.0, "enc1": 1300.0, "enc2": 700.0, "dec0": 2000.0,
          "dec1": 1300.0}
    got = counters.model_flops(bk, head_channels(model), sp, pairs,
                               model["additional_info"])
    assert got == pytest.approx(hand_count(points, pairs, lambda n: n),
                                rel=1e-12)


def test_mfu_count_doubles_the_attention_and_mlp_count():
    """Without the terms it adds (xCPE, the embedding, pooling, heads), the
    mfu count is twice the gflops.csv count."""
    model = base_flash()["config"]["model"]
    bk = backbone_kwargs(model["backbone"])
    sp = {"enc0": 2000.0, "enc1": 1300.0, "enc2": 700.0, "dec0": 2000.0,
          "dec1": 1300.0}
    got = counters.model_flops(bk, head_channels(model), sp, [0.0] * 3,
                               model["additional_info"])
    xcpe_linear = 2 * sum(sp[k] * c * c for k, c in (
        ("enc0", 32), ("enc1", 48), ("enc2", 64), ("dec0", 32),
        ("dec1", 48)))
    attn, mlp = counters.ptv3_attention_mlp_gflops(
        bk, sp, model["additional_info"])
    assert got["block_dense"] + got["attn_products"] - xcpe_linear == \
        pytest.approx(2e9 * (attn + mlp), rel=1e-12)


def test_lpips_count():
    # VGG16 at 64 x 64: the 13 convolutions' multiply-adds, doubled
    want, cin, hw = 0, 3, 64
    for ch, convs in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(convs):
            want += hw * hw * 9 * cin * ch
            cin = ch
        hw //= 2
    assert counters.lpips_flops(1, 64, 64) == 2 * want
